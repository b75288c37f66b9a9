"""PSMNet, NCHW / NCDHW (counterpart of `openstereo_tpu/models/psmnet/psmnet.py:32-219`).

SPP backbone (32 channels at 1/4) → concat volume [B,64,D/4,H/4,W/4] →
dres0/dres1 → three shared-skip 3D hourglasses → three classifiers, summed
→ align-corners trilinear upsample to [B,D,H,W] → softmax over D →
soft-argmax. Every 3D conv runs on cuDNN: no TPU kernel lies on this path.
Training (`psmnet.py:150-219`) runs the backbone once per view and
regresses the three partial sums (cost1, cost1+cost2, cost1+cost2+cost3);
`get_loss` weighs their masked smooth-L1s 0.5, 0.7, 1.0. With `remat`
(MODEL.REMAT) each hourglass and each regression head is recomputed in the
backward instead of kept (`layers.remat`).

Attribute names follow the reference OpenStereo PSMNet state_dict, as
`openstereo_tpu/utils/torch_convert.py:convert_psmnet` reads it:
`Backbone.firstconv.{0,1,2}`, `Backbone.layerN.i.{conv1,conv2,downsample}`,
`Backbone.branch{1..4}.1`, `Backbone.lastconv.{0,1}`, and
`CostProcessor.aggregator.{dres0,dres1,dres2..4,classif1..3}`, each conv +
BatchNorm a bias-free Sequential(conv, bn) with its ReLU applied in forward.
`ResBlock` also serves GwcNet, whose reference nests conv1 one level deeper.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import build_concat_volume, disparity_regression, resize_linear_align_corners
from ..layers import convbn, deconv_bn, head_dtype, remat, run_conv, run_seq, siamese
from ..losses import weighted_heads_loss


class ResBlock(nn.Module):
    """conv-bn-relu + conv-bn with an additive skip, no post-activation
    (`psmnet.py:32-50`). A 1×1 conv-bn `downsample` carries the skip when
    the stride or the width changes.

    Keys: `conv1.{0,1}` (PSMNet), or `conv1.0.{0,1}` with `nested` (GwcNet
    and CasNet, whose reference conv1 is Sequential(convbn, ReLU), and
    CFNet's `MishResBlock` with `act` a Mish); `conv2.{0,1}`;
    `downsample.{0,1}`.
    """

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1, dilation: int = 1,
                 nested: bool = False, act: Optional[nn.Module] = None):
        super().__init__()
        conv1 = convbn(in_ch, out_ch, 3, stride, dilation)
        self.conv1 = nn.Sequential(conv1, act or nn.ReLU()) if nested else conv1
        self.nested = nested
        self.conv2 = convbn(out_ch, out_ch, 3, 1, dilation)
        self.downsample = (convbn(in_ch, out_ch, 1, stride)
                           if stride != 1 or in_ch != out_ch else None)

    def forward(self, x):
        y = run_seq(x, self.conv1)
        y = run_seq(y if self.nested else F.relu(y), self.conv2)
        return y + (run_seq(x, self.downsample) if self.downsample is not None else x)


def res_layer(in_ch: int, out_ch: int, blocks: int, stride: int = 1, dilation: int = 1,
              nested: bool = False) -> nn.Sequential:
    """`blocks` ResBlocks, the first one changing stride and width."""
    return nn.Sequential(ResBlock(in_ch, out_ch, stride, dilation, nested),
                         *[ResBlock(out_ch, out_ch, 1, dilation, nested)
                           for _ in range(blocks - 1)])


class SPPBackbone(nn.Module):
    """PSMNet feature extractor: residual trunk + spatial pyramid pooling →
    32 channels at 1/4 (`psmnet.py:53-94`)."""

    def __init__(self):
        super().__init__()
        self.firstconv = nn.Sequential(convbn(3, 32, 3, 2), convbn(32, 32), convbn(32, 32))
        self.layer1 = res_layer(32, 32, 3)
        self.layer2 = res_layer(32, 64, 16, stride=2)
        self.layer3 = res_layer(64, 128, 3)
        self.layer4 = res_layer(128, 128, 3, dilation=2)
        # branch k pools over 64, 32, 16, 8 (k = 1..4); index 0 keeps the window
        for k, pool in enumerate((64, 32, 16, 8), start=1):
            setattr(self, f"branch{k}", nn.Sequential(nn.AvgPool2d(pool), convbn(128, 32, 1)))
        self.lastconv = nn.Sequential(convbn(320, 128, 3), nn.Conv2d(128, 32, 1, bias=False))

    def forward(self, x):
        for seq in self.firstconv:
            x = F.relu(run_seq(x, seq))
        out_4_0 = self.layer2(self.layer1(x))
        out_8 = self.layer4(self.layer3(out_4_0))
        h, w = out_8.shape[-2:]
        branches = []
        for k in range(4, 0, -1):  # pools 8, 16, 32, 64: the JAX concat order
            branch = getattr(self, f"branch{k}")
            # the window is clamped to the feature size (`psmnet.py:82`), so
            # small inputs stay valid; at 544×960 every window fits
            ph, pw = min(branch[0].kernel_size, h), min(branch[0].kernel_size, w)
            b = F.relu(run_seq(F.avg_pool2d(out_8, (ph, pw), (ph, pw)), branch[1]))
            branches.append(resize_linear_align_corners(b, (h, w)))
        feat = torch.cat([out_4_0, out_8] + branches, dim=1)  # 320 channels
        feat = F.relu(run_seq(feat, self.lastconv[0]))
        return run_conv(feat, self.lastconv[1])


class Hourglass3D(nn.Module):
    """Shared-skip 3D hourglass (`psmnet.py:97-127`): in [B,C,D,H,W] →
    (out [B,C,...], pre [B,2C,...]/2, post [B,2C,...]/2)."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = convbn(c, 2 * c, 3, 2, ndim=3)
        self.conv2 = convbn(2 * c, 2 * c, 3, ndim=3)
        self.conv3 = convbn(2 * c, 2 * c, 3, 2, ndim=3)
        self.conv4 = convbn(2 * c, 2 * c, 3, ndim=3)
        self.conv5 = deconv_bn(2 * c, 2 * c, 3, "batch", ndim=3)
        self.conv6 = deconv_bn(2 * c, c, 3, "batch", ndim=3)

    def forward(self, x, presqu: Optional[torch.Tensor] = None,
                postsqu: Optional[torch.Tensor] = None):
        out = F.relu(run_seq(x, self.conv1))
        pre = run_seq(out, self.conv2)
        pre = F.relu(pre + postsqu if postsqu is not None else pre)
        out = F.relu(run_seq(pre, self.conv3))
        out = F.relu(run_seq(out, self.conv4))
        post = F.relu(run_seq(out, self.conv5) + (presqu if presqu is not None else pre))
        return run_seq(post, self.conv6), pre, post


class PSMAggregator(nn.Module):
    """dres0/dres1 + three hourglasses + three classifiers, summed
    (`psmnet.py:162-192`): concat volume → cost [B,1,D/4,H/4,W/4]."""

    def __init__(self, in_ch: int = 64, c: int = 32):
        super().__init__()
        self.dres0 = nn.Sequential(convbn(in_ch, c, ndim=3), convbn(c, c, ndim=3))
        self.dres1 = nn.Sequential(convbn(c, c, ndim=3), convbn(c, c, ndim=3))
        for i in (2, 3, 4):
            setattr(self, f"dres{i}", Hourglass3D(c))
        for j in (1, 2, 3):
            setattr(self, f"classif{j}", nn.Sequential(
                convbn(c, c, ndim=3), nn.Conv3d(c, 1, 3, padding=1, bias=False)))

    def classify(self, x, j: int):
        seq = getattr(self, f"classif{j}")
        return run_conv(F.relu(run_seq(x, seq[0])), seq[1])

    def costs(self, volume, use_remat: bool = False) -> Tuple[torch.Tensor, ...]:
        """(cost1, cost1 + cost2, cost1 + cost2 + cost3), each [B,1,D/4,H/4,W/4];
        the hourglasses under `remat` with `use_remat`."""
        cost0 = F.relu(run_seq(volume, self.dres0[0]))
        cost0 = F.relu(run_seq(cost0, self.dres0[1]))
        res = F.relu(run_seq(cost0, self.dres1[0]))
        cost0 = run_seq(res, self.dres1[1]) + cost0
        outs, skips = [], (None, None)
        x = cost0
        for i in (2, 3, 4):
            hg = getattr(self, f"dres{i}")
            out, *skips = remat(hg, x, *skips) if use_remat else hg(x, *skips)
            x = out + cost0
            outs.append(x)
        cost1 = self.classify(outs[0], 1)
        cost2 = self.classify(outs[1], 2) + cost1
        return cost1, cost2, self.classify(outs[2], 3) + cost2

    def forward(self, volume):
        return self.costs(volume)[2]


class PSMNet(nn.Module):
    """forward(data) → {'disp_pred': [B,H,W]}, in training also
    {'train_preds': the three heads' [B,H,W]}.

    data['left'] / data['right']: [B,3,H,W] normalized images, H and W
    multiples of 16. `dtype` is the compute dtype (bf16 on the main path);
    parameters stay f32 and the regression head runs in at least f32.
    """

    head_weights = (0.5, 0.7, 1.0)

    def __init__(self, max_disp: int = 192, remat: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.max_disp = max_disp
        self.remat = remat
        self.dtype = dtype
        self.Backbone = SPPBackbone()
        self.CostProcessor = nn.ModuleDict({"aggregator": PSMAggregator()})

    def regress(self, cost: torch.Tensor, size) -> torch.Tensor:
        """[B,1,D/4,H/4,W/4] → [B,H,W]: align-corners trilinear to [B,D,H,W]
        in the head dtype, softmax over D, soft-argmax."""
        cost = resize_linear_align_corners(cost.to(head_dtype(self.dtype)),
                                           (self.max_disp, *size))
        return disparity_regression(torch.softmax(cost[:, 0], dim=1), self.max_disp)

    def forward(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        left, right = data["left"].to(self.dtype), data["right"].to(self.dtype)
        if self.training:
            # one call per view: each gets its own BatchNorm batch statistics
            feat_l, feat_r = self.Backbone(left), self.Backbone(right)
        else:
            feat_l, feat_r = siamese(self.Backbone, left, right)
        volume = build_concat_volume(feat_l, feat_r, self.max_disp // 4)
        size = tuple(left.shape[-2:])
        agg = self.CostProcessor["aggregator"]
        if not self.training:
            return {"disp_pred": self.regress(agg(volume), size)}
        preds = [remat(self.regress, c, size) if self.remat else self.regress(c, size)
                 for c in agg.costs(volume, self.remat)]
        return {"disp_pred": preds[2], "train_preds": preds}

    def get_loss(self, pred: Dict, data: Dict):
        """Σ head_weights · masked smooth-L1 of the three heads over
        0 < gt < max_disp (`psmnet.py:209-219`) → (loss, {'loss_disp'})."""
        loss = weighted_heads_loss(pred["train_preds"], data["disp"], self.max_disp,
                                   self.head_weights)
        return loss, {"loss_disp": loss}
