"""MobileNetV2-1.0 trunk, NCHW (counterpart of `openstereo_tpu/models/backbones/mobilenetv2.py:23-81`).

Attribute names follow timm's `mobilenetv2_100` as the reference re-slices
it. LightStereo's layout (`utils/torch_convert.py:_ls_trunk`): conv_stem/bn1,
block0 = blocks[0], block1..2 = blocks[1..2], block3 = blocks[3:5] (children
"3" and "4"), block4 = blocks[5]. The `sliced` layout of CoEx and IGEV
(`_timm_trunk_sliced`) wraps each slice in one more Sequential:
block0.0.0, blockK.<stage within the slice>.<block>. Stage taps:

    c1 16@1/2 · c2 24@1/4 · c3 32@1/8 · c4 96@1/16 · c5 160@1/32
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List

import torch.nn as nn

from ..layers import FusableMBConv, apply_norm, relu6, run_conv


class DepthwiseSeparable(nn.Module):
    """Stage 0 (expand ratio 1): dw3×3 → pw-linear, no residual (32 → 16).
    No expand, so it stays on cuDNN, as the TPU kernel leaves it to XLA."""

    def __init__(self, inp: int, oup: int):
        super().__init__()
        self.conv_dw = nn.Conv2d(inp, inp, 3, 1, 1, groups=inp, bias=False)
        self.bn1 = nn.BatchNorm2d(inp)
        self.conv_pw = nn.Conv2d(inp, oup, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(oup)

    def forward(self, x):
        x = relu6(apply_norm(run_conv(x, self.conv_dw), self.bn1))
        return apply_norm(run_conv(x, self.conv_pw), self.bn2)


class InvertedResidual(FusableMBConv):
    """timm InvertedResidual: conv_pw/bn1 → conv_dw/bn2 → conv_pwl/bn3.
    Stride-1 blocks run the fused MBConv kernel in eval."""

    def __init__(self, inp: int, oup: int, stride: int = 1, expand_ratio: int = 6):
        super().__init__()
        hidden = inp * expand_ratio
        self.use_res = stride == 1 and inp == oup
        self.fusable = stride == 1
        self.conv_pw = nn.Conv2d(inp, hidden, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(hidden)
        self.conv_dw = nn.Conv2d(hidden, hidden, 3, stride, 1, groups=hidden, bias=False)
        self.bn2 = nn.BatchNorm2d(hidden)
        self.conv_pwl = nn.Conv2d(hidden, oup, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(oup)

    def _mbconv_parts(self):
        return (self.conv_pw.weight, self.bn1, self.conv_dw.weight, self.bn2,
                self.conv_pwl.weight, self.bn3)

    def forward(self, x):
        y = self.forward_fused(x)
        if y is not None:
            return y
        y = relu6(apply_norm(run_conv(x, self.conv_pw), self.bn1))
        y = relu6(apply_norm(run_conv(y, self.conv_dw), self.bn2))
        y = apply_norm(run_conv(y, self.conv_pwl), self.bn3)
        return x + y if self.use_res else y


# (expand_ratio, channels, repeats, stride) per stage — MobileNetV2-1.0
_STAGES = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
]


def _stage(si: int, inp: int) -> nn.Sequential:
    t, c, n, s = _STAGES[si]
    return nn.Sequential(*[InvertedResidual(inp if i == 0 else c, c, s if i == 0 else 1, t)
                           for i in range(n)])


class MobileNetV2Features(nn.Module):
    """[B,3,H,W] → [c1@1/2, c2@1/4, c3@1/8, c4@1/16, c5@1/32].

    `stem_act` False applies the stem BN with no relu6, as CoEx's trunk does
    (`backbones/mobilenetv2.py:56-70`); `sliced` picks CoEx's key layout."""

    def __init__(self, stem_act: bool = True, sliced: bool = False):
        super().__init__()
        self.stem_act = stem_act
        self.conv_stem = nn.Conv2d(3, 32, 3, 2, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(32)
        block0 = nn.Sequential(DepthwiseSeparable(32, 16))
        if sliced:
            self.block0 = nn.Sequential(block0)
            self.block1 = nn.Sequential(_stage(1, 16))
            self.block2 = nn.Sequential(_stage(2, 24))
            self.block3 = nn.Sequential(_stage(3, 32), _stage(4, 64))
            self.block4 = nn.Sequential(_stage(5, 96))
        else:
            self.block0 = block0
            self.block1 = _stage(1, 16)
            self.block2 = _stage(2, 24)
            self.block3 = nn.Sequential(OrderedDict([("3", _stage(3, 32)), ("4", _stage(4, 64))]))
            self.block4 = _stage(5, 96)

    def forward(self, x) -> List:
        x = apply_norm(run_conv(x, self.conv_stem), self.bn1)
        if self.stem_act:
            x = relu6(x)
        taps = []
        for blk in (self.block0, self.block1, self.block2, self.block3, self.block4):
            x = blk(x)
            taps.append(x)
        return taps
