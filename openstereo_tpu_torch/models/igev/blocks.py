"""IGEV building blocks that CoEx uses, NCHW / NCDHW (counterpart of part of
`openstereo_tpu/models/igev/blocks.py`).

`BasicConvBN` (conv, BatchNorm, leaky_relu 0.01), `Conv2x` (a 2× deconv,
merged with a skip and fused) and `FeatureAtt` (a sigmoid gate from image
features, broadcast over the disparity axis). Attribute names follow the
reference submodules as `openstereo_tpu/utils/torch_convert.py` reads them
(`.conv`, `.bn`; `_conv2x`, `_feature_att`, `_coex_channel_att`). The
InstanceNorm variants and the rest of IGEV wait for ROADMAP item 14.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ...ops import resize_nearest
from ..layers import apply_norm, leaky_relu, ntuple, run_conv


class BasicConvBN(nn.Module):
    """conv (or a k4 s2 p1 deconv) + BatchNorm + leaky_relu 0.01, each
    optional (`igev/blocks.py:46-64`); 2D or, with ndim=3, 3D. The conv pads
    (k-1)//2 per axis; kernel and stride are an int or one per axis. Keys:
    conv, bn."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size=3, stride=1, deconv: bool = False,
                 bn: bool = True, relu: bool = True, ndim: int = 2):
        super().__init__()
        ks, st = ntuple(kernel_size, ndim), ntuple(stride, ndim)
        if deconv:
            # flax's "SAME" transposed conv equals torch's k4 s2 p1 only for
            # that kernel and stride (`layers.py:214-263`)
            if set(ks) != {4} or set(st) != {2}:
                raise NotImplementedError(f"deconv kernel {ks}, stride {st}: only k4 s2")
            self.conv = (nn.ConvTranspose2d if ndim == 2 else nn.ConvTranspose3d)(
                in_ch, out_ch, ks, st, padding=1, bias=False)
        else:
            self.conv = (nn.Conv2d if ndim == 2 else nn.Conv3d)(
                in_ch, out_ch, ks, st, padding=tuple((k - 1) // 2 for k in ks), bias=False)
        if bn:
            self.bn = (nn.BatchNorm2d if ndim == 2 else nn.BatchNorm3d)(out_ch)
        self.act = leaky_relu() if relu else None

    def forward(self, x):
        x = run_conv(x, self.conv)
        if hasattr(self, "bn"):
            x = apply_norm(x, self.bn)
        return self.act(x) if self.act is not None else x


class Conv2x(nn.Module):
    """conv1: a k4 s2 deconv, nearest-resized to the skip's size where the
    two differ; concatenated with the skip (whose width is out_ch, as the
    reference assumes), conv2 fuses to 2·out_ch (`igev/blocks.py:67-99`,
    the flavour CoEx uses: deconv, BatchNorm, concat, keep_concat).
    Keys: conv1, conv2."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = BasicConvBN(in_ch, out_ch, 4, 2, deconv=True)
        self.conv2 = BasicConvBN(2 * out_ch, 2 * out_ch, 3, 1)

    def forward(self, x, rem):
        x = self.conv1(x)
        if x.shape[2:] != rem.shape[2:]:
            x = resize_nearest(x, rem.shape[2:])
        return self.conv2(torch.cat([x, rem], dim=1))


class FeatureAtt(nn.Module):
    """Gate a [B,Cv,D,H,W] volume by sigmoid(a 1×1 BasicConvBN to half the
    image-feature width, then a 1×1 conv with bias to Cv), broadcast over D
    (`igev/blocks.py:102-117`). Keys: im_att.{0,1}, as CoEx's reference
    channelAtt names them (IGEV's reference says feat_att: item 14)."""

    def __init__(self, cv_ch: int, feat_ch: int):
        super().__init__()
        self.im_att = nn.Sequential(BasicConvBN(feat_ch, feat_ch // 2, 1),
                                    nn.Conv2d(feat_ch // 2, cv_ch, 1))

    def forward(self, cv, feat):
        a = run_conv(self.im_att[0](feat), self.im_att[1])
        return torch.sigmoid(a)[:, :, None] * cv
