"""LightStereo S/M/L, NCHW (counterpart of `openstereo_tpu/models/lightstereo/lightstereo.py:33-216`).

The correlation volume comes out [B,D,H/4,W/4] with disparity as channels,
so the aggregation UNet is a stack of ordinary 2D convs. Attribute names
follow the reference OpenStereo LightStereo state_dict (the keys that
`openstereo_tpu/utils/torch_convert.py:convert_lightstereo` reads), so a
reference `.pth` loads as it is.

With `use_kernels` on (the default) the eval path runs the correlation
volume and every stride-1 MBConv with an expand through the CUDA kernels
of `ops/` (on a CPU tensor, their plain versions); off, it runs the eager
PyTorch/cuDNN path. In training (`model.train()`) the backbone runs once
per view, the volume is the plain one under autograd and every MBConv runs
its eager chain, as the JAX model trains (`lightstereo.py:170-216`).
Variants differ only in blocks and expanse ratio:
S (1,2,4)/4, M (4,8,16)/4, L (8,16,32)/8. LX (EfficientNetV2) is not
ported yet.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import (context_upsample, corr_volume, correlation_volume, disparity_regression,
                   resize_bilinear)
from ..backbones import MobileNetV2Features
from ..losses import disp_valid_mask, masked_smooth_l1
from ..layers import (ConvBlock, DeconvBlock, MobileV2Residual, deconv_bn, head_dtype,
                      leaky_relu, run_conv, run_seq, siamese)


class FPNLayer(nn.Module):
    """Upsample low-res, concat with high-res, fuse (`lightstereo.py:33-45`)."""

    def __init__(self, low_ch: int, high_ch: int, features: int):
        super().__init__()
        self.deconv = DeconvBlock(low_ch, features, 4, norm="batch", act=leaky_relu(0.2))
        self.conv = ConvBlock(high_ch + features, features, 3, norm="batch",
                              act=leaky_relu(0.2))

    def forward(self, low, high):
        low = self.deconv(low)
        return self.conv(torch.cat([high, low], dim=1))


class Backbone(MobileNetV2Features):
    """Trunk + FPN → [p2@1/4, p3@1/8, p4@1/16, c5@1/32] (`lightstereo.py:48-79`).

    The reference keys the trunk's modules directly under `backbone.`
    (conv_stem, block0..4), hence a subclass and not a `trunk` member."""

    output_channels = (24, 32, 96, 160)

    def __init__(self):
        super().__init__()
        ch = self.output_channels
        self.fpn_layer4 = FPNLayer(160, ch[2], ch[2])
        self.fpn_layer3 = FPNLayer(ch[2], 32, ch[1])
        self.fpn_layer2 = FPNLayer(ch[1], 24, ch[0])
        self.out_conv = ConvBlock(ch[0], ch[0], 3, norm="instance", pad_mode="replicate")

    def forward(self, images):
        c1, c2, c3, c4, c5 = super().forward(images)
        p4 = self.fpn_layer4(c5, c4)
        p3 = self.fpn_layer3(p4, c3)
        p2 = self.fpn_layer2(p3, c2)
        return [self.out_conv(p2), p3, p4, c5]


class AttentionModule(nn.Module):
    """Strip attention over the cost volume, guided by left features
    (`lightstereo.py:82-102`). Keys conv0 (proj), conv{0,1,2}_{1,2}
    (strips 7/11/21, horizontal then vertical), conv3 (out)."""

    def __init__(self, features: int, img_ch: int):
        super().__init__()
        d = features
        self.conv0 = nn.Conv2d(img_ch, d, 1)
        for i, k in enumerate((7, 11, 21)):
            setattr(self, f"conv{i}_1", nn.Conv2d(d, d, (1, k), padding=(0, k // 2), groups=d))
            setattr(self, f"conv{i}_2", nn.Conv2d(d, d, (k, 1), padding=(k // 2, 0), groups=d))
        self.conv3 = nn.Conv2d(d, d, 1)

    def forward(self, cost, img_feat):
        attn = run_conv(img_feat, self.conv0)
        total = attn
        for i in range(3):
            b = run_conv(attn, getattr(self, f"conv{i}_1"))
            total = total + run_conv(b, getattr(self, f"conv{i}_2"))
        return run_conv(total, self.conv3) * cost


class Aggregation(nn.Module):
    """MobileV2-residual UNet over the D-as-channels volume (`lightstereo.py:105-150`)."""

    def __init__(self, in_channels: int, blocks: Sequence[int], expanse_ratio: int,
                 left_att: bool = True, backbone_channels: Sequence[int] = (24, 32, 96)):
        super().__init__()
        ch, r = in_channels, expanse_ratio
        self.left_att = left_att
        self.conv0 = nn.Sequential(*[MobileV2Residual(ch, ch, 1, r) for _ in range(blocks[0])])
        self.conv1 = MobileV2Residual(ch, ch * 2, 2, r)
        self.conv2 = nn.Sequential(*[MobileV2Residual(ch * 2, ch * 2, 1, r)
                                     for _ in range(blocks[1] - 1)])
        self.conv3 = MobileV2Residual(ch * 2, ch * 4, 2, r)
        self.conv4 = nn.Sequential(*[MobileV2Residual(ch * 4, ch * 4, 1, r)
                                     for _ in range(blocks[2] - 1)])
        if left_att:
            self.att0 = AttentionModule(ch, backbone_channels[0])
            self.att2 = AttentionModule(ch * 2, backbone_channels[1])
            self.att4 = AttentionModule(ch * 4, backbone_channels[2])
        self.conv5 = deconv_bn(ch * 4, ch * 2, 3, norm="batch")
        self.conv6 = deconv_bn(ch * 2, ch, 3, norm="batch")
        self.redir1 = MobileV2Residual(ch, ch, 1, r)
        self.redir2 = MobileV2Residual(ch * 2, ch * 2, 1, r)

    def forward(self, volume, features_left):
        x = self.conv0(volume)
        if self.left_att:
            x = self.att0(x, features_left[0])
        conv2 = self.conv2(self.conv1(x))
        if self.left_att:
            conv2 = self.att2(conv2, features_left[1])
        conv4 = self.conv4(self.conv3(conv2))
        if self.left_att:
            conv4 = self.att4(conv4, features_left[2])
        conv5 = F.relu(run_seq(conv4, self.conv5) + self.redir2(conv2))
        return F.relu(run_seq(conv5, self.conv6) + self.redir1(x))


class LightStereo(nn.Module):
    """forward(data) → {'disp_pred': [B,H,W]}, and in training also
    'disp_4' [B,H,W], the 1/4-scale disparity upsampled.

    data['left'] / data['right']: [B,3,H,W] normalized images, H and W
    multiples of 32. `dtype` is the compute dtype (bf16 on the main path);
    parameters stay f32 and the heads run in at least f32.
    """

    use_kernels = True

    def __init__(self, max_disp: int = 192, expanse_ratio: int = 4,
                 aggregation_blocks: Sequence[int] = (1, 2, 4), left_att: bool = True,
                 backbone: str = "MobileNetv2", dtype: torch.dtype = torch.float32):
        super().__init__()
        if backbone != "MobileNetv2":
            raise NotImplementedError(
                f"backbone {backbone!r} (LightStereo-LX) is ROADMAP Slice F item 19")
        self.max_disp = max_disp
        self.dtype = dtype
        self.backbone = Backbone()
        self.cost_agg = Aggregation(max_disp // 4, tuple(aggregation_blocks), expanse_ratio,
                                    left_att, Backbone.output_channels[:3])
        self.refine_1 = nn.Sequential(
            ConvBlock(24, 24, 3, norm="instance", act=leaky_relu()),
            ConvBlock(24, 24, 3, norm="instance", act=F.relu))
        self.stem_2 = nn.Sequential(
            ConvBlock(3, 16, 3, stride=2, norm="batch", act=leaky_relu()),
            ConvBlock(16, 16, 3, norm="batch", act=F.relu))
        self.refine_2 = FPNLayer(24, 16, 16)
        self.refine_3 = DeconvBlock(16, 9, 4)

    def forward(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        left = data["left"].to(self.dtype)
        right = data["right"].to(self.dtype)
        if self.training:
            # one call per view: each gets its own BatchNorm batch statistics, and
            # the running statistics are updated for the left view, then the right
            feats_l, feats_r = self.backbone(left), self.backbone(right)
        else:
            feats_l, feats_r = siamese(self.backbone, left, right)

        d4 = self.max_disp // 4
        # K1's wrapper has no backward: training builds the plain volume under
        # autograd, as the JAX model trains its jnp builder
        corr = corr_volume if self.use_kernels and not self.training else correlation_volume
        volume = corr(feats_l[0].contiguous(), feats_r[0].contiguous(), d4)
        volume = self.cost_agg(volume, feats_l)

        hd = head_dtype(self.dtype)
        prob = torch.softmax(volume.to(hd), dim=1)
        init_disp = disparity_regression(prob, d4)  # [B,H/4,W/4]

        xspx = self.refine_1(feats_l[0])
        stem2 = self.stem_2(left)
        xspx = self.refine_3(self.refine_2(xspx, stem2))
        spx_pred = torch.softmax(xspx.to(hd), dim=1)  # [B,9,H,W]
        out = {"disp_pred": context_upsample(init_disp * 4.0, spx_pred)}
        if self.training:
            size = tuple(left.shape[-2:])
            out["disp_4"] = resize_bilinear(init_disp[:, None], size)[:, 0] * 4.0
        return out

    def get_loss(self, pred: Dict[str, torch.Tensor], data: Dict[str, torch.Tensor]):
        """Smooth-L1 on 'disp_pred' + 0.3 × smooth-L1 on 'disp_4', over
        0 < gt < max_disp (`lightstereo.py:210-216`) → (loss, {'loss_disp'})."""
        gt = data["disp"]
        mask = disp_valid_mask(gt, self.max_disp)
        loss = masked_smooth_l1(pred["disp_pred"], gt, mask)
        loss = loss + 0.3 * masked_smooth_l1(pred["disp_4"], gt, mask)
        return loss, {"loss_disp": loss}
