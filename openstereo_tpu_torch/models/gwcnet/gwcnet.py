"""GwcNet eval, NCHW / NCDHW (counterpart of `openstereo_tpu/models/gwcnet/gwcnet.py`).

Residual backbone (group-wise features of 320 channels at 1/4, and 12-channel
concat features) → group-wise correlation volume [B,G,D/4,H/4,W/4] ⧺ concat
volume [B,24,D/4,H/4,W/4] → dres0/dres1 → three hourglasses with redir skips
→ `classif3` → trilinear upsample to [B,D,H,W] → softmax over D →
soft-argmax. Eval runs only the last classifier; `classif0`-`classif2` are
kept for the training heads and for loading reference checkpoints.

With `use_kernels` on (the default) the group-wise volume goes through the
CUDA kernel K3 (`ops.gwc_volume`; on a CPU tensor, its plain version);
off, through the plain PyTorch builder. Every 3D conv runs on cuDNN.

Attribute names follow the reference OpenStereo GwcNet state_dict, as
`openstereo_tpu/utils/torch_convert.py:convert_gwcnet` reads it:
`Backbone.feature_extraction.{firstconv,layerN,lastconv}` and
`DispProcessor.{dres0,dres1,dres2..4,classif0..3}`, with the reference's
Sequential indices (ReLUs included).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from ...ops import (build_concat_volume, build_gwc_volume, disparity_regression, gwc_volume,
                    resize_trilinear)
from ..layers import convbn, deconv_bn, head_dtype, run_seq, siamese
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

    def forward(self, volume):
        cost0 = run_seq(volume, self.dres0)
        cost0 = run_seq(cost0, self.dres1) + cost0
        out3 = self.dres4(self.dres3(self.dres2(cost0)))
        return run_seq(out3, self.classif3)


class GwcNet(nn.Module):
    """forward(data) → {'disp_pred': [B,H,W]} (eval).

    data['left'] / data['right']: [B,3,H,W] normalized images, H and W
    multiples of 16. `dtype` is the compute dtype (bf16 on the main path);
    parameters stay f32 and the regression head runs in at least f32.
    """

    use_kernels = True

    def __init__(self, max_disp: int = 192, num_groups: int = 40,
                 use_concat_volume: bool = True, concat_channels: int = 12,
                 downsample: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.max_disp, self.num_groups, self.downsample = max_disp, num_groups, downsample
        self.use_concat_volume = use_concat_volume
        self.dtype = dtype
        self.Backbone = nn.ModuleDict(
            {"feature_extraction": GwcBackbone(use_concat_volume, concat_channels)})
        in_ch = num_groups + (2 * concat_channels if use_concat_volume else 0)
        self.DispProcessor = GwcDispProcessor(in_ch)

    def forward(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self.training:
            raise NotImplementedError("GwcNet training is ROADMAP item 8")
        left = data["left"].to(self.dtype)
        feat_l, feat_r = siamese(self.Backbone["feature_extraction"], left,
                                 data["right"].to(self.dtype))
        d4 = self.max_disp // self.downsample
        gwc = gwc_volume if self.use_kernels else build_gwc_volume
        volume = gwc(feat_l["gwc_feature"].contiguous(), feat_r["gwc_feature"].contiguous(),
                     d4, self.num_groups)
        if self.use_concat_volume:
            cat = build_concat_volume(feat_l["concat_feature"], feat_r["concat_feature"], d4)
            volume = torch.cat([volume, cat], dim=1)
        cost = self.DispProcessor(volume)  # [B,1,D/4,H/4,W/4]
        h, w = left.shape[-2:]
        cost = resize_trilinear(cost.to(head_dtype(self.dtype)), (self.max_disp, h, w))
        prob = torch.softmax(cost[:, 0], dim=1)
        return {"disp_pred": disparity_regression(prob, self.max_disp)}
