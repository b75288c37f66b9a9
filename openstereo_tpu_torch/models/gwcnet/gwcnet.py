"""GwcNet, NCHW / NCDHW (counterpart of `openstereo_tpu/models/gwcnet/gwcnet.py`).

Residual backbone (group-wise features of 320 channels at 1/4, and 12-channel
concat features) → group-wise correlation volume [B,G,D/4,H/4,W/4] ⧺ concat
volume [B,24,D/4,H/4,W/4] → dres0/dres1 → three hourglasses with redir skips
→ `classif3` → trilinear upsample to [B,D,H,W] → softmax over D →
soft-argmax. Eval runs only the last classifier. Training (`gwcnet.py:
119-194`) runs the backbone once per view, so BatchNorm takes each view's
statistics, and regresses all four classifiers (`classif0` on the
pre-hourglass cost, `classif1`-`classif3` on the hourglasses'); `get_loss`
weighs their masked smooth-L1s 0.5, 0.5, 0.7, 1.0. With `remat`
(MODEL.REMAT) each hourglass and each regression head is recomputed in the
backward instead of kept (`layers.remat`).

With `use_kernels` on (the default) the eval group-wise volume goes through
the CUDA kernel K3 (`ops.gwc_volume`; on a CPU tensor, its plain version);
off, and always in training (K3 has no backward, and the JAX model trains
its jnp builder), through the plain PyTorch builder. Every 3D conv runs on
cuDNN.

Attribute names follow the reference OpenStereo GwcNet state_dict, as
`openstereo_tpu/utils/torch_convert.py:convert_gwcnet` reads it:
`Backbone.feature_extraction.{firstconv,layerN,lastconv}` and
`DispProcessor.{dres0,dres1,dres2..4,classif0..3}`, with the reference's
Sequential indices (ReLUs included).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from ...ops import (build_concat_volume, build_gwc_volume, disparity_regression, gwc_volume,
                    resize_trilinear)
from ..layers import convbn, deconv_bn, head_dtype, remat, run_seq, siamese
from ..losses import weighted_heads_loss
from ..psmnet.psmnet import res_layer


class GwcBackbone(nn.Module):
    """Residual trunk → {'gwc_feature': concat(l2, l3, l4), 320 channels at 1/4,
    'concat_feature': `concat_channels` at 1/4 (with `concat_feature`)}
    (`gwcnet.py:33-67`)."""

    def __init__(self, concat_feature: bool = True, concat_channels: int = 12):
        super().__init__()
        self.firstconv = nn.Sequential(convbn(3, 32, 3, 2), nn.ReLU(), convbn(32, 32), nn.ReLU(),
                                       convbn(32, 32), nn.ReLU())
        self.layer1 = res_layer(32, 32, 3, nested=True)
        self.layer2 = res_layer(32, 64, 16, stride=2, nested=True)
        self.layer3 = res_layer(64, 128, 3, nested=True)
        self.layer4 = res_layer(128, 128, 3, dilation=2, nested=True)
        if concat_feature:
            self.lastconv = nn.Sequential(convbn(320, 128, 3), nn.ReLU(),
                                          nn.Conv2d(128, concat_channels, 1, bias=False))
        self.concat_feature = concat_feature

    def forward(self, x) -> Dict[str, torch.Tensor]:
        l2 = self.layer2(self.layer1(run_seq(x, self.firstconv)))
        l3 = self.layer3(l2)
        l4 = self.layer4(l3)
        gwc = torch.cat([l2, l3, l4], dim=1)
        out = {"gwc_feature": gwc}
        if self.concat_feature:
            out["concat_feature"] = run_seq(gwc, self.lastconv)
        return out


def convbn_act_3d(in_ch: int, out_ch: int, stride: int = 1,
                  act: Optional[nn.Module] = None) -> nn.Sequential:
    """Sequential(convbn 3D, act), act a ReLU unless given."""
    return nn.Sequential(convbn(in_ch, out_ch, 3, stride, ndim=3), act or nn.ReLU())


class GwcHourglass(nn.Module):
    """Unshared 3D hourglass with 1×1 redir skips (`gwcnet.py:70-98`). With
    `act` (an activation module, ReLU by default) it is also CFNet's
    `MishHourglass` (`cfnet.py:161-187`), which has the same keys."""

    def __init__(self, c: int, act: Optional[nn.Module] = None):
        super().__init__()
        act = act or nn.ReLU()
        self.act = act
        self.conv1 = convbn_act_3d(c, 2 * c, 2, act)
        self.conv2 = convbn_act_3d(2 * c, 2 * c, 1, act)
        self.conv3 = convbn_act_3d(2 * c, 4 * c, 2, act)
        self.conv4 = convbn_act_3d(4 * c, 4 * c, 1, act)
        self.conv5 = deconv_bn(4 * c, 2 * c, 3, "batch", ndim=3)
        self.conv6 = deconv_bn(2 * c, c, 3, "batch", ndim=3)
        self.redir1 = convbn(c, c, 1, ndim=3)
        self.redir2 = convbn(2 * c, 2 * c, 1, ndim=3)

    def forward(self, x):
        conv2 = run_seq(run_seq(x, self.conv1), self.conv2)
        conv4 = run_seq(run_seq(conv2, self.conv3), self.conv4)
        conv5 = run_seq(run_seq(conv4, self.conv5) + run_seq(conv2, self.redir2), [self.act])
        return run_seq(run_seq(conv5, self.conv6) + run_seq(x, self.redir1), [self.act])


class GwcDispProcessor(nn.Module):
    """dres0/dres1 + three hourglasses + the classifiers (`gwcnet.py:140-162`):
    volume → cost [B,1,D/4,H/4,W/4] of `classif3`."""

    def __init__(self, in_ch: int, c: int = 32):
        super().__init__()
        self.dres0 = nn.Sequential(convbn(in_ch, c, ndim=3), nn.ReLU(),
                                   convbn(c, c, ndim=3), nn.ReLU())
        self.dres1 = nn.Sequential(convbn(c, c, ndim=3), nn.ReLU(), convbn(c, c, ndim=3))
        for i in (2, 3, 4):
            setattr(self, f"dres{i}", GwcHourglass(c))
        for j in range(4):
            setattr(self, f"classif{j}", nn.Sequential(
                convbn(c, c, ndim=3), nn.ReLU(), nn.Conv3d(c, 1, 3, padding=1, bias=False)))

    def stages(self, volume, use_remat: bool = False) -> Tuple[torch.Tensor, ...]:
        """(cost0, out1, out2, out3): the pre-hourglass cost and each
        hourglass's output, the hourglasses under `remat` with `use_remat`."""
        cost0 = run_seq(volume, self.dres0)
        cost0 = run_seq(cost0, self.dres1) + cost0
        outs = [cost0]
        for i in (2, 3, 4):
            hg = getattr(self, f"dres{i}")
            outs.append(remat(hg, outs[-1]) if use_remat else hg(outs[-1]))
        return tuple(outs)

    def forward(self, volume):
        return run_seq(self.stages(volume)[3], self.classif3)


class GwcNet(nn.Module):
    """forward(data) → {'disp_pred': [B,H,W]}, in training also
    {'disp_preds': the four heads' [B,H,W]}.

    data['left'] / data['right']: [B,3,H,W] normalized images, H and W
    multiples of 16. `dtype` is the compute dtype (bf16 on the main path);
    parameters stay f32 and the regression head runs in at least f32.
    """

    use_kernels = True
    head_weights = (0.5, 0.5, 0.7, 1.0)

    def __init__(self, max_disp: int = 192, num_groups: int = 40,
                 use_concat_volume: bool = True, concat_channels: int = 12,
                 downsample: int = 4, remat: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.max_disp, self.num_groups, self.downsample = max_disp, num_groups, downsample
        self.use_concat_volume = use_concat_volume
        self.remat = remat
        self.dtype = dtype
        self.Backbone = nn.ModuleDict(
            {"feature_extraction": GwcBackbone(use_concat_volume, concat_channels)})
        in_ch = num_groups + (2 * concat_channels if use_concat_volume else 0)
        self.DispProcessor = GwcDispProcessor(in_ch)

    def regress(self, cost: torch.Tensor, size) -> torch.Tensor:
        """[B,1,D/4,H/4,W/4] → [B,H,W]: trilinear (half-pixel, the JAX
        model's `jax.image.resize`) to [B,D,H,W] in the head dtype, softmax
        over D, soft-argmax."""
        cost = resize_trilinear(cost.to(head_dtype(self.dtype)), (self.max_disp, *size))
        return disparity_regression(torch.softmax(cost[:, 0], dim=1), self.max_disp)

    def forward(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        left, right = data["left"].to(self.dtype), data["right"].to(self.dtype)
        backbone = self.Backbone["feature_extraction"]
        if self.training:
            # one call per view: each gets its own BatchNorm batch statistics, and
            # the running statistics are updated for the left view, then the right
            feat_l, feat_r = backbone(left), backbone(right)
        else:
            feat_l, feat_r = siamese(backbone, left, right)
        d4 = self.max_disp // self.downsample
        # K3's wrapper has no backward: training builds the plain volume under
        # autograd, as the JAX model trains its jnp builder
        gwc = gwc_volume if self.use_kernels and not self.training else build_gwc_volume
        volume = gwc(feat_l["gwc_feature"].contiguous(), feat_r["gwc_feature"].contiguous(),
                     d4, self.num_groups)
        if self.use_concat_volume:
            cat = build_concat_volume(feat_l["concat_feature"], feat_r["concat_feature"], d4)
            volume = torch.cat([volume, cat], dim=1)
        size = tuple(left.shape[-2:])
        dp = self.DispProcessor
        if not self.training:
            return {"disp_pred": self.regress(dp(volume), size)}  # dp: [B,1,D/4,H/4,W/4]
        preds: List[torch.Tensor] = []
        for j, x in enumerate(dp.stages(volume, self.remat)):
            cost = run_seq(x, getattr(dp, f"classif{j}"))
            preds.append(remat(self.regress, cost, size) if self.remat
                         else self.regress(cost, size))
        return {"disp_pred": preds[3], "disp_preds": preds}

    def get_loss(self, pred: Dict, data: Dict):
        """Σ head_weights · masked smooth-L1 of the four heads over
        0 < gt < max_disp (`gwcnet.py:188-194`) → (loss, {'loss_disp'})."""
        loss = weighted_heads_loss(pred["disp_preds"], data["disp"], self.max_disp,
                                   self.head_weights)
        return loss, {"loss_disp": loss}
