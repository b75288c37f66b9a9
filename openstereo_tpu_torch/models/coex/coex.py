"""CoEx, NCHW / NCDHW (counterpart of `openstereo_tpu/models/coex/coex.py:36-196`).

MobileNetV2 trunk (stem BN without its relu6) + the BatchNorm FeatUp decoder,
as one siamese 2B batch; a stem_2/stem_4 superpixel branch run on each view;
the cosine volume (descriptors divided by their norm, then K1's mean product
over 48 channels, × 48) [B,1,D/4,H/4,W/4]; a 3-level 3D UNet with
disparity-strided steps and guided cost-volume excitation (FeatureAtt) at
every scale; the top-k (k 2) soft-argmax and the superpixel upsample.
Training (`coex.py:78-82`, `:182-196`) runs the trunk and decoder once per
view and adds a second head, the 1/4 disparity ×4 bilinearly upsampled;
`get_loss` is 0.77·(smooth-L1 of the full head + 0.3 × the low one's). The
top-2 head's gradient reaches the two chosen costs only, as
`jax.lax.top_k`'s does.

With `use_kernels` on (the default) the eval volume goes through the CUDA
kernel K1 (`ops.corr_volume`; on a CPU tensor, its plain version) and the
trunk's stride-1 blocks through K2; off, and always in training (neither
kernel has a backward), through the plain builder and the eager blocks.
Every 3D conv runs on cuDNN. The JAX model's `@pin_impl3d` only picks a TPU
lowering and has no counterpart here.

Attribute names follow the reference OpenStereo CoEx state_dict, as
`openstereo_tpu/utils/torch_convert.py:convert_coex` reads it:
`Backbone.{feat,up,stem_2,stem_4}`, `CostProcessor.{cost_volume,cost_agg}`,
`DispProcessor.{spx,spx_2,spx_4}`. The reference also carries modules its
forward never runs; the converter drops them, and `REFERENCE_ONLY_KEYS`
names them so that a reference checkpoint loads (`tools/infer.py`).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn

from ...ops import (context_upsample, corr_volume, correlation_volume, resize_bilinear,
                    resize_nearest, topk_disparity_regression)
from ..backbones import MobileNetV2Features
from ..igev.blocks import BasicConvBN, Conv2x, FeatureAtt
from ..layers import head_dtype, run_conv, run_seq, siamese
from ..losses import weighted_heads_loss


class FeatUp(nn.Module):
    """BatchNorm FPN decoder (`coex.py:36-51`): [x4, x8, x16, x32] →
    [48@1/4, 64@1/8, 192@1/16, x32]."""

    def __init__(self):
        super().__init__()
        self.deconv32_16 = Conv2x(160, 96)
        self.deconv16_8 = Conv2x(192, 32)
        self.deconv8_4 = Conv2x(64, 24)
        self.conv4 = BasicConvBN(48, 48, 3)

    def forward(self, feats):
        x4, x8, x16, x32 = feats
        y16 = self.deconv32_16(x32, x16)
        y8 = self.deconv16_8(y16, x8)
        y4 = self.conv4(self.deconv8_4(y8, x4))
        return [y4, y8, y16, x32]


class CoExBackbone(nn.Module):
    """Keys: feat (the trunk, sliced layout), up (FeatUp), stem_2 and stem_4
    (BasicConvBN, conv, BN, ReLU)."""

    def __init__(self, spixel_channels: Sequence[int]):
        super().__init__()
        sp0, sp1 = spixel_channels
        self.feat = MobileNetV2Features(stem_act=False, sliced=True)
        self.up = FeatUp()
        self.stem_2 = nn.Sequential(BasicConvBN(3, sp0, 3, 2),
                                    nn.Conv2d(sp0, sp0, 3, 1, 1, bias=False),
                                    nn.BatchNorm2d(sp0), nn.ReLU())
        self.stem_4 = nn.Sequential(BasicConvBN(sp0, sp1, 3, 2),
                                    nn.Conv2d(sp1, sp1, 3, 1, 1, bias=False),
                                    nn.BatchNorm2d(sp1), nn.ReLU())

    def features(self, x):
        return self.up(self.feat(x)[1:])


class CostAggregation(nn.Module):
    """The 3D UNet (`coex.py:118-158`). Keys as the reference's cost_agg:
    conv_stem, channelAttStem, conv_down.i.n, channelAttDown.i, conv_up.j,
    conv_skip.j, conv_agg.j.{0,1}, channelAtt.j (j 1, 2: the reference's
    index-0 skip, agg and att modules are never run)."""

    def __init__(self, channels: Sequence[int], blocks: Sequence[int], disp_stride: int,
                 feat_channels: Sequence[int], gce: bool):
        super().__init__()
        if disp_stride != 2:
            raise NotImplementedError(
                f"aggregation_disp_strides {disp_stride}: the port takes 2 (its k4 deconvs "
                "equal flax's only at stride 2)")
        chs = [8] + list(channels)
        stride = (disp_stride, 2, 2)
        self.gce = gce
        self.conv_stem = BasicConvBN(1, 8, 3, ndim=3)
        self.conv_down = nn.ModuleList(
            nn.ModuleList(BasicConvBN(chs[i] if n == 0 else chs[i + 1], chs[i + 1], 3,
                                      stride if n == 0 else 1, ndim=3) for n in range(blocks[i]))
            for i in range(3))
        self.conv_up = nn.ModuleList(
            BasicConvBN(chs[j + 1], 1 if j == 0 else chs[j], 4, stride, deconv=True, bn=j != 0,
                        relu=j != 0, ndim=3) for j in range(3))
        self.conv_skip = nn.ModuleDict(
            {str(j): BasicConvBN(2 * chs[j], chs[j], 1, ndim=3) for j in (1, 2)})
        self.conv_agg = nn.ModuleDict(
            {str(j): nn.ModuleList(BasicConvBN(chs[j], chs[j], 3, ndim=3) for _ in range(2))
             for j in (1, 2)})
        if gce:
            self.channelAttStem = FeatureAtt(8, feat_channels[0])
            self.channelAttDown = nn.ModuleList(
                FeatureAtt(chs[i + 1], feat_channels[i + 1]) for i in range(3))
            self.channelAtt = nn.ModuleDict(
                {str(j): FeatureAtt(chs[j], feat_channels[j]) for j in (1, 2)})

    def forward(self, cost, feats):
        cost = self.conv_stem(cost)
        if self.gce:
            cost = self.channelAttStem(cost, feats[0])
        cost_feat = [cost]
        cur = cost
        for i in range(3):
            for block in self.conv_down[i]:
                cur = block(cur)
            if self.gce:
                cur = self.channelAttDown[i](cur, feats[i + 1])
            cost_feat.append(cur)
        for j in (2, 1, 0):
            cur = self.conv_up[j](cur)
            skip = cost_feat[j]
            if cur.shape[2:] != skip.shape[2:]:
                cur = resize_nearest(cur, skip.shape[2:])
            if j == 0:
                break
            cur = self.conv_skip[str(j)](torch.cat([cur, skip], dim=1))
            for block in self.conv_agg[str(j)]:
                cur = block(cur)
            if self.gce:
                cur = self.channelAtt[str(j)](cur, feats[j])
        return cur[:, 0]  # [B,D,H/4,W/4]


def cosine_normalize(x: torch.Tensor) -> torch.Tensor:
    """x / (‖x‖ over channels + 1e-12) in x's dtype, rounding where the JAX
    program does (`coex.py:110-111`): `jnp.linalg.norm` is itself jitted, and
    XLA keeps its squares in f32 there (f64 for an f64 x), so the squares and their sum are f32
    and the sum is rounded to x's dtype; its sqrt, the + 1e-12 and the
    quotient are each rounded."""
    xf = x.to(head_dtype(x.dtype))
    sq = (xf * xf).sum(dim=1, keepdim=True).to(x.dtype)
    return x / (torch.sqrt(sq) + 1e-12)


class CoExNet(nn.Module):
    """forward(data) → {'disp_pred': [B,H,W]}, in training also
    {'disp_preds': [full, low]}.

    data['left'] / data['right']: [B,3,H,W] normalized images, H and W
    multiples of 4. `dtype` is the compute dtype (bf16 on the main path);
    parameters stay f32 and the regression heads run in at least f32.
    """

    use_kernels = True
    HIDDEN = 48  # the cost volume's descriptor width (`coex.py:101`)
    REFERENCE_ONLY_KEYS = ("Backbone.feat.up.", "CostProcessor.cost_agg.conv_up.0.bn.",
                           "CostProcessor.cost_agg.conv_skip.0.",
                           "CostProcessor.cost_agg.conv_agg.0.",
                           "CostProcessor.cost_agg.channelAtt.0.")

    def __init__(self, max_disp: int = 192, spixel_branch_channels: Sequence[int] = (32, 48),
                 matching_weighted: bool = False, gce: bool = True,
                 aggregation_disp_strides: int = 2,
                 aggregation_channels: Sequence[int] = (16, 32, 48),
                 aggregation_blocks_num: Sequence[int] = (2, 2, 2), regression_topk: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if matching_weighted:
            raise NotImplementedError("CoEx matching_weighted is not ported (its reference key "
                                      "is not in the converter)")
        self.max_disp, self.topk, self.dtype = max_disp, regression_topk, dtype
        sp0, sp1 = spixel_branch_channels
        feat_ch = (48 + sp1, 64, 192, 160)  # FeatUp's outputs, the 1/4 one with stem_4
        self.Backbone = CoExBackbone(spixel_branch_channels)
        self.CostProcessor = nn.Module()
        self.CostProcessor.cost_volume = nn.Module()
        self.CostProcessor.cost_volume.conv = BasicConvBN(feat_ch[0], self.HIDDEN, 3)
        self.CostProcessor.cost_volume.desc = nn.Conv2d(self.HIDDEN, self.HIDDEN, 1)
        self.CostProcessor.cost_agg = CostAggregation(
            aggregation_channels, aggregation_blocks_num, aggregation_disp_strides, feat_ch, gce)
        self.DispProcessor = nn.Module()
        self.DispProcessor.spx_4 = nn.Sequential(
            BasicConvBN(feat_ch[0], 24, 3), nn.Conv2d(24, 24, 3, 1, 1, bias=False),
            nn.BatchNorm2d(24), nn.ReLU())
        self.DispProcessor.spx_2 = Conv2x(24, sp0)
        self.DispProcessor.spx = nn.Sequential(nn.ConvTranspose2d(2 * sp0, 9, 4, 2, 1))

    def descriptors(self, feat: torch.Tensor) -> torch.Tensor:
        cv = self.CostProcessor.cost_volume
        return cosine_normalize(run_conv(cv.conv(feat), cv.desc))

    def forward(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        bb = self.Backbone
        left, right = data["left"].to(self.dtype), data["right"].to(self.dtype)
        if self.training:
            # one call per view: each gets its own BatchNorm batch statistics
            feats_l, feats_r = bb.features(left), bb.features(right)
        else:
            feats_l, feats_r = siamese(bb.features, left, right)
        stem_2x, stem_2y = run_seq(left, bb.stem_2), run_seq(right, bb.stem_2)
        feats_l[0] = torch.cat([feats_l[0], run_seq(stem_2x, bb.stem_4)], dim=1)
        feats_r[0] = torch.cat([feats_r[0], run_seq(stem_2y, bb.stem_4)], dim=1)

        x, y = self.descriptors(feats_l[0]), self.descriptors(feats_r[0])
        # K1's wrapper has no backward: training builds the plain volume
        corr = corr_volume if self.use_kernels and not self.training else correlation_volume
        # the mean over HIDDEN channels rounded, then × HIDDEN rounded again (`coex.py:113`)
        cost = corr(x.contiguous(), y.contiguous(), self.max_disp // 4) * self.HIDDEN
        cost = self.CostProcessor.cost_agg(cost[:, None], feats_l)  # [B,D,H/4,W/4]

        dp = self.DispProcessor
        hd = head_dtype(self.dtype)
        xspx = dp.spx_2(run_seq(feats_l[0], dp.spx_4), stem_2x)
        spx_pred = torch.softmax(run_seq(xspx, dp.spx).to(hd), dim=1)  # [B,9,H,W]
        disp_4 = topk_disparity_regression(cost.to(hd), self.topk)  # [B,H/4,W/4]
        disp_1 = context_upsample(disp_4 * 4.0, spx_pred)
        if not self.training:
            return {"disp_pred": disp_1}
        low = resize_bilinear((disp_4 * 4.0)[:, None], tuple(left.shape[-2:]))[:, 0]
        return {"disp_pred": disp_1, "disp_preds": [disp_1, low]}

    def get_loss(self, pred: Dict, data: Dict):
        """0.77 · (1.0 · smooth-L1 of the full head + 0.3 · the low head's),
        over 0 < gt < max_disp (`coex.py:187-196`) → (loss, {'loss_disp'})."""
        loss = weighted_heads_loss(pred["disp_preds"], data["disp"], self.max_disp,
                                   (1.0, 0.3)) * 0.77
        return loss, {"loss_disp": loss}
