"""IGEV building blocks, NCHW / NCDHW (counterpart of `openstereo_tpu/models/igev/blocks.py`).

`BasicConvBN` and `BasicConvIN` (conv, BatchNorm or InstanceNorm,
leaky_relu 0.01), `Conv2x` (a 2× deconv or stride-2 conv, merged with a
skip and fused), `FeatureAtt` (a sigmoid gate from image features,
broadcast over the disparity axis), the MobileNetV2 + decoder `Feature`
trunk, and the context net `MultiBasicEncoder` with its `ResidualBlockCtx`.
CoEx uses the first four. Attribute names follow the reference submodules
as `openstereo_tpu/utils/torch_convert.py` reads them (`.conv`, `.bn`;
`_conv2x`, `_feature_att`, `_igev_feature`, `_multi_basic_encoder`), or,
with `spelling="block"`, StereoBase's (`.block.0`, `.block.1`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import resize_nearest
from ..backbones import MobileNetV2Features
from ..layers import apply_norm, leaky_relu, ntuple, run_conv, run_seq


def _conv_or_deconv(in_ch: int, out_ch: int, kernel_size, stride, deconv: bool, ndim: int):
    """A bias-free conv padded (k-1)//2 per axis, or a k4 s2 p1 deconv."""
    ks, st = ntuple(kernel_size, ndim), ntuple(stride, ndim)
    if deconv:
        # flax's "SAME" transposed conv equals torch's k4 s2 p1 only for
        # that kernel and stride (`layers.py:214-263`)
        if set(ks) != {4} or set(st) != {2}:
            raise NotImplementedError(f"deconv kernel {ks}, stride {st}: only k4 s2")
        return (nn.ConvTranspose2d if ndim == 2 else nn.ConvTranspose3d)(
            in_ch, out_ch, ks, st, padding=1, bias=False)
    return (nn.Conv2d if ndim == 2 else nn.Conv3d)(
        in_ch, out_ch, ks, st, padding=tuple((k - 1) // 2 for k in ks), bias=False)


def _hold(module: nn.Module, conv: nn.Module, norm: Optional[nn.Module], norm_key: str,
          spelling: str):
    """Register a block's conv and norm under one of the two key spellings of
    the reference: "igev" (its igev/igevpp `BasicConv`: keys conv and, for a
    BatchNorm, `norm_key`) or "block" (StereoBase's `BasicConv2d`/`3d`:
    block.0 the conv, block.1 the norm; `torch_convert.py:_conv2x` and
    `_geo_hourglass` read both)."""
    if spelling == "block":
        module.block = nn.Sequential(conv, *([norm] if norm is not None else []))
    elif spelling == "igev":
        module.conv = conv
        if norm is not None:
            setattr(module, norm_key, norm)
    else:
        raise ValueError(f"unknown spelling {spelling!r}")


def _conv_norm_act(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The held conv, then its norm, then the activation."""
    if hasattr(module, "block"):
        conv, norm = module.block[0], (module.block[1] if len(module.block) > 1 else None)
    else:
        conv, norm = module.conv, getattr(module, module.norm_key, None)
    x = run_conv(x, conv)
    if norm is not None:
        x = apply_norm(x, norm)
    return module.act(x) if module.act is not None else x


class BasicConvBN(nn.Module):
    """conv (or a k4 s2 p1 deconv) + BatchNorm + leaky_relu 0.01, each
    optional (`igev/blocks.py:46-64`); 2D or, with ndim=3, 3D. The conv pads
    (k-1)//2 per axis; kernel and stride are an int or one per axis. Keys:
    conv, bn, or with `spelling` "block" block.0, block.1 (`_hold`)."""

    norm_key = "bn"

    def __init__(self, in_ch: int, out_ch: int, kernel_size=3, stride=1, deconv: bool = False,
                 bn: bool = True, relu: bool = True, ndim: int = 2, spelling: str = "igev"):
        super().__init__()
        norm = (nn.BatchNorm2d if ndim == 2 else nn.BatchNorm3d)(out_ch) if bn else None
        _hold(self, _conv_or_deconv(in_ch, out_ch, kernel_size, stride, deconv, ndim), norm,
              self.norm_key, spelling)
        self.act = leaky_relu() if relu else None

    def forward(self, x):
        return _conv_norm_act(self, x)


class BasicConvIN(nn.Module):
    """conv (or a k4 s2 p1 deconv) + non-affine InstanceNorm + leaky_relu 0.01
    (`igev/blocks.py:26-43`); 2D or, with ndim=3, 3D, whose InstanceNorm
    takes its statistics over D, H and W. Key: conv, or block.0 with
    `spelling` "block" (the norm has no parameters)."""

    norm_key = "IN"

    def __init__(self, in_ch: int, out_ch: int, kernel_size=3, stride=1, deconv: bool = False,
                 relu: bool = True, ndim: int = 2, spelling: str = "igev"):
        super().__init__()
        norm = (nn.InstanceNorm2d if ndim == 2 else nn.InstanceNorm3d)(out_ch)
        _hold(self, _conv_or_deconv(in_ch, out_ch, kernel_size, stride, deconv, ndim), norm,
              self.norm_key, spelling)
        self.act = leaky_relu() if relu else None

    def forward(self, x):
        return _conv_norm_act(self, x)


class Conv2x(nn.Module):
    """conv1: a k4 s2 deconv (`deconv`) or a k3 s2 conv, nearest-resized with
    half-pixel centres to the skip's size where the two differ; then
    concatenated with the skip (whose width is out_ch, as the reference
    assumes) or added to it; conv2 fuses to 2·out_ch (`keep_concat`) or
    out_ch (`igev/blocks.py:67-99`). `norm` "batch", "instance" or "none"
    picks BasicConvBN, BasicConvIN or BasicConvBN without its norm, each
    in `spelling`. Keys: conv1, conv2."""

    def __init__(self, in_ch: int, out_ch: int, deconv: bool = True, concat: bool = True,
                 norm: str = "batch", keep_concat: bool = True, spelling: str = "igev"):
        super().__init__()
        if norm == "instance":
            def basic(*args, **kw):
                return BasicConvIN(*args, spelling=spelling, **kw)
        elif norm in ("batch", "none"):
            def basic(*args, **kw):
                return BasicConvBN(*args, bn=norm == "batch", spelling=spelling, **kw)
        else:
            raise ValueError(f"unknown norm {norm!r}")
        self.concat = concat
        self.conv1 = basic(in_ch, out_ch, 4 if deconv else 3, 2, deconv=deconv)
        mid = 2 * out_ch if concat else out_ch
        self.conv2 = basic(mid, out_ch * (2 if concat and keep_concat else 1), 3, 1)

    def forward(self, x, rem):
        x = self.conv1(x)
        if x.shape[2:] != rem.shape[2:]:
            x = resize_nearest(x, rem.shape[2:])
        x = torch.cat([x, rem], dim=1) if self.concat else x + rem
        return self.conv2(x)


class FeatureAtt(nn.Module):
    """Gate a [B,Cv,D,H,W] volume by sigmoid(a 1×1 BasicConvBN, or with `norm`
    "instance" BasicConvIN (IGEV++), to half the image-feature width, then a
    1×1 conv with bias to Cv), broadcast over D (`igev/blocks.py:102-117`).
    Keys: `key`.{0,1}: im_att as CoEx's reference channelAtt names it,
    feat_att as IGEV's reference does; the first in `spelling`."""

    def __init__(self, cv_ch: int, feat_ch: int, key: str = "im_att", norm: str = "batch",
                 spelling: str = "igev"):
        super().__init__()
        if norm not in ("batch", "instance"):
            raise ValueError(f"unknown norm {norm!r}")
        basic = BasicConvBN if norm == "batch" else BasicConvIN
        self.key = key
        setattr(self, key, nn.Sequential(basic(feat_ch, feat_ch // 2, 1, spelling=spelling),
                                         nn.Conv2d(feat_ch // 2, cv_ch, 1)))

    def forward(self, cv, feat):
        att = getattr(self, self.key)
        a = run_conv(att[0](feat), att[1])
        return torch.sigmoid(a)[:, :, None] * cv


class Feature(MobileNetV2Features):
    """IGEV's image features (`igev/blocks.py:120-137`): the MobileNetV2 trunk
    (stem with relu6, the sliced key layout: conv_stem, bn1, block0..4), then
    three InstanceNorm Conv2x deconv stages and conv4, in `spelling`:
    [B,3,H,W] → [y4 48@1/4, y8 64@1/8, y16 192@1/16, x32 160@1/32]."""

    def __init__(self, spelling: str = "igev"):
        super().__init__(stem_act=True, sliced=True)
        self.deconv32_16 = Conv2x(160, 96, norm="instance", spelling=spelling)
        self.deconv16_8 = Conv2x(192, 32, norm="instance", spelling=spelling)
        self.deconv8_4 = Conv2x(64, 24, norm="instance", spelling=spelling)
        self.conv4 = BasicConvIN(48, 48, 3, spelling=spelling)

    def forward(self, x):
        _, x4, x8, x16, x32 = super().forward(x)
        y16 = self.deconv32_16(x32, x16)
        y8 = self.deconv16_8(y16, x8)
        y4 = self.conv4(self.deconv8_4(y8, x4))
        return [y4, y8, y16, x32]


class ResidualBlockCtx(nn.Module):
    """The context net's residual block, BatchNorm as every config of the zoo
    runs it (`igev/blocks.py:140-158`): conv1 (3×3, stride, bias) + BN +
    relu, conv2 (3×3, bias) + BN + relu, plus x, through `downsample` (1×1
    conv with bias + BN) where the stride or the width changes; relu. Keys:
    conv1, norm1, conv2, norm2, downsample.{0,1}."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, stride, 1)
        self.norm1 = nn.BatchNorm2d(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, 1, 1)
        self.norm2 = nn.BatchNorm2d(out_ch)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(nn.Conv2d(in_ch, out_ch, 1, stride),
                                            nn.BatchNorm2d(out_ch))

    def forward(self, x):
        y = F.relu(apply_norm(run_conv(x, self.conv1), self.norm1))
        y = F.relu(apply_norm(run_conv(y, self.conv2), self.norm2))
        if self.downsample is not None:
            x = run_seq(x, self.downsample)
        return F.relu(x + y)


class MultiBasicEncoder(nn.Module):
    """The context encoder with BatchNorm at N_DOWNSAMPLE 2, as every config of
    the zoo runs it (`igev/blocks.py:161-205`): a 7×7 conv (stride 1) + BN +
    relu, five layers of two residual blocks (64; 96 and 128 at stride 2 each:
    1/4; 128 at 1/8 and 1/16), and per output of `output_dims` ([[d16, d8,
    d4], ...]) a residual block + 3×3 conv head at 1/4 and 1/8 and a 3×3 conv
    at 1/16. Returns [outs 1/4, outs 1/8, outs 1/16], each one tensor per
    output. Keys: conv1, norm1, layer1..5.{0,1}, outputs04.i.{0,1},
    outputs08.i.{0,1}, outputs16.i."""

    def __init__(self, output_dims: Sequence[Sequence[int]]):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 1, 3)
        self.norm1 = nn.BatchNorm2d(64)
        widths = [(64, 64, 1), (64, 96, 2), (96, 128, 2), (128, 128, 2), (128, 128, 2)]
        for i, (cin, cout, s) in enumerate(widths):
            setattr(self, f"layer{i + 1}", nn.Sequential(ResidualBlockCtx(cin, cout, s),
                                                         ResidualBlockCtx(cout, cout, 1)))
        for scale, idx in (("04", 2), ("08", 1)):
            setattr(self, f"outputs{scale}", nn.ModuleList(
                nn.Sequential(ResidualBlockCtx(128, 128),
                              nn.Conv2d(128, dims[idx], 3, padding=1)) for dims in output_dims))
        self.outputs16 = nn.ModuleList(nn.Conv2d(128, dims[0], 3, padding=1)
                                       for dims in output_dims)

    def forward(self, x):
        x = F.relu(apply_norm(run_conv(x, self.conv1), self.norm1))
        x = self.layer3(self.layer2(self.layer1(x)))
        out04 = [run_conv(head[0](x), head[1]) for head in self.outputs04]
        x = self.layer4(x)
        out08 = [run_conv(head[0](x), head[1]) for head in self.outputs08]
        x = self.layer5(x)
        out16 = [run_conv(x, head) for head in self.outputs16]
        return [out04, out08, out16]
