"""STTR feature extractor, tokenizer and context adjustment, NCHW
(counterpart of `openstereo_tpu/models/sttr/blocks.py`).

Attribute names follow the reference STTR state_dict, the keys that
`openstereo_tpu/utils/torch_convert.py:convert_sttr` reads (`backbone.in_conv.0`,
`tokenizer.up.2.convTrans.0`, `regression_head.cal.layers.0.module.0`). Every
norm is the parameter-free InstanceNorm (eps 1e-5), which owns no keys.
Convs run in their input's dtype (`layers.run_conv`).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import resize_bilinear
from ..layers import compute_weight, head_dtype, run_conv


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    """Non-affine InstanceNorm, eps 1e-5, statistics in at least f32. Written
    out because `F.instance_norm` refuses a 1×1 map, which the coarsest SPP
    branch gives at small inputs (flax returns zeros there)."""
    xf = x.to(head_dtype(x.dtype))
    var, mean = torch.var_mean(xf, dim=(-2, -1), unbiased=False, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + 1e-5)).to(x.dtype)


def conv_in_relu(x: torch.Tensor, seq: nn.Sequential) -> torch.Tensor:
    """Run a Sequential of (conv, InstanceNorm, ReLU) triples."""
    for m in seq:
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            x = run_conv(x, m)
        elif isinstance(m, nn.InstanceNorm2d):
            x = instance_norm(x)
        elif isinstance(m, nn.ReLU):
            x = F.relu(x)
        else:
            raise TypeError(f"unexpected module {type(m).__name__}")
    return x


def _conv_in_relu(cin: int, cout: int, k: int = 3, stride: int = 1) -> List[nn.Module]:
    return [nn.Conv2d(cin, cout, k, stride, padding=k // 2, bias=False),
            nn.InstanceNorm2d(cout), nn.ReLU()]


class TVBasicBlockIN(nn.Module):
    """torchvision BasicBlock with InstanceNorm (`blocks.py:22-38`).
    Keys: conv1, conv2, downsample.0."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, padding=1, bias=False)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, padding=1, bias=False)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                                            nn.InstanceNorm2d(cout))

    def forward(self, x):
        y = F.relu(instance_norm(run_conv(x, self.conv1)))
        y = instance_norm(run_conv(y, self.conv2))
        if self.downsample is not None:
            x = instance_norm(run_conv(x, self.downsample[0]))
        return F.relu(x + y)


class SppBackboneIN(nn.Module):
    """Contracting path → [src(3), 64@1/4, 128@1/8, 128@1/16] (`blocks.py:41-75`).

    Keys: in_conv.{0,3,6}, resblock_{1,2}.{i}, branch{1..4}.1. The SPP pools
    are clamped to the map (`min(pool, size)`), as in the JAX package.
    """

    POOLS = (16, 8, 4, 2)

    def __init__(self):
        super().__init__()
        self.in_conv = nn.Sequential(*_conv_in_relu(3, 16, 3, 2), *_conv_in_relu(16, 16),
                                     *_conv_in_relu(16, 32))
        self.resblock_1 = nn.Sequential(TVBasicBlockIN(32, 64, 2), TVBasicBlockIN(64, 64),
                                        TVBasicBlockIN(64, 64))
        self.resblock_2 = nn.Sequential(TVBasicBlockIN(64, 128, 2), TVBasicBlockIN(128, 128),
                                        TVBasicBlockIN(128, 128))
        for i, pool in enumerate(self.POOLS):
            setattr(self, f"branch{i + 1}",
                    nn.Sequential(nn.AvgPool2d(pool), *_conv_in_relu(128, 32, 1)))

    def forward(self, x) -> List[torch.Tensor]:
        src = x
        out1 = self.resblock_1(conv_in_relu(x, self.in_conv))
        out2 = self.resblock_2(out1)
        size16 = (-(-src.shape[-2] // 16), -(-src.shape[-1] // 16))
        branches = []
        for i, pool in enumerate(self.POOLS):
            window = (min(pool, out2.shape[-2]), min(pool, out2.shape[-1]))
            b = F.avg_pool2d(out2, window, window)
            b = conv_in_relu(b, getattr(self, f"branch{i + 1}")[1:])
            branches.append(resize_bilinear(b, size16))
        return [src, out1, out2, torch.cat(branches, dim=1)]


class DenseLayerIN(nn.Module):
    """IN-relu-conv1×1(bn_size·g) → IN-relu-conv3×3(g). Keys: conv1, conv2."""

    def __init__(self, cin: int, growth_rate: int, bn_size: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, bn_size * growth_rate, 1, bias=False)
        self.conv2 = nn.Conv2d(bn_size * growth_rate, growth_rate, 3, padding=1, bias=False)

    def forward(self, x):
        y = run_conv(F.relu(instance_norm(x)), self.conv1)
        return run_conv(F.relu(instance_norm(y)), self.conv2)


class DenseBlockIN(nn.Module):
    """DenseNet block with InstanceNorm (`blocks.py:78-107`). Returns the whole
    concatenation; callers keep the last num_layers·growth_rate channels.
    Keys: denselayer{1..n}."""

    def __init__(self, num_layers: int, cin: int, growth_rate: int = 4, bn_size: int = 4):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"denselayer{i + 1}",
                            DenseLayerIN(cin + i * growth_rate, growth_rate, bn_size))

    def forward(self, x):
        for layer in self.children():
            x = torch.cat([x, layer(x)], dim=1)
        return x


def center_crop(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    h, w = x.shape[-2:]
    y0, x0 = (h - th) // 2, (w - tw) // 2
    return x[..., y0:y0 + th, x0:x0 + tw]


class TransitionUp(nn.Module):
    """ConvTranspose k3 s2 p0 (out = 2·in+1), ×2 or ×4, centre-cropped to the
    skip and concatenated with it (`blocks.py:110-137`). Keys: convTrans (×2,
    with bias), or convTrans.{0,2} (×4: bias-free deconv, IN, deconv)."""

    def __init__(self, cin: int, cout: int, scale: int = 2):
        super().__init__()
        if scale == 2:
            self.convTrans = nn.ConvTranspose2d(cin, cout, 3, 2, bias=True)
        elif scale == 4:
            self.convTrans = nn.Sequential(nn.ConvTranspose2d(cin, cout, 3, 2, bias=False),
                                           nn.InstanceNorm2d(cout),
                                           nn.ConvTranspose2d(cout, cout, 3, 2, bias=True))
        else:
            raise ValueError(f"TransitionUp scale must be 2 or 4, got {scale}")

    def forward(self, x, skip):
        if isinstance(self.convTrans, nn.Sequential):
            x = conv_in_relu(x, self.convTrans)
        else:
            x = run_conv(x, self.convTrans)
        x = center_crop(x, skip.shape[-2], skip.shape[-1])
        return torch.cat([x, skip], dim=1)


class Tokenizer(nn.Module):
    """Expanding path → full-resolution hidden_dim tokens (`blocks.py:140-171`).
    Keys: bottle_neck, up.{0,1,2}, dense_block.{0,1}, dense_block.2.double_conv.{0,3}."""

    def __init__(self, hidden_dim: int = 128, growth_rate: int = 4,
                 block_config: Sequence[int] = (4, 4, 4, 4)):
        super().__init__()
        g = growth_rate
        bc = list(block_config)[::-1]
        self.new = [bc[0] * g, bc[1] * g, bc[2] * g]
        self.bottle_neck = DenseBlockIN(bc[0], 128, g)
        self.up = nn.ModuleList([TransitionUp(self.new[0], self.new[0], 2),
                                 TransitionUp(self.new[1], self.new[1], 2),
                                 TransitionUp(self.new[2], hidden_dim, 4)])
        double_conv = nn.Sequential(*_conv_in_relu(hidden_dim + 3, hidden_dim),
                                    *_conv_in_relu(hidden_dim, hidden_dim))
        self.dense_block = nn.ModuleList([DenseBlockIN(bc[1], self.new[0] + 128, g),
                                          DenseBlockIN(bc[2], self.new[1] + 64, g),
                                          nn.ModuleDict({"double_conv": double_conv})])

    def forward(self, features: List[torch.Tensor]) -> torch.Tensor:
        src, out1, out2, out3 = features
        y = self.bottle_neck(out3)[:, -self.new[0]:]
        y = self.dense_block[0](self.up[0](y, out2))[:, -self.new[1]:]  # 1/16 → 1/8
        y = self.dense_block[1](self.up[1](y, out1))[:, -self.new[2]:]  # 1/8 → 1/4
        y = self.up[2](y, src)                                           # 1/4 → full
        return conv_in_relu(y, self.dense_block[2]["double_conv"])


class WNConv(nn.Module):
    """Weight-normalised 3×3 conv (`blocks.py:174-191`): weight =
    weight_v · weight_g / sqrt(Σ weight_v² + 1e-12) per output channel, in at
    least f32, then cast to the input's dtype. Parameters: weight_g
    [O,1,1,1], weight_v [O,I,3,3], bias [O] (the reference's weight_norm
    names). Without autograd the weight is cached per parameter version."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3):
        super().__init__()
        self.weight_g = nn.Parameter(torch.ones(cout, 1, 1, 1))
        self.weight_v = nn.Parameter(torch.empty(cout, cin, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.padding = kernel_size // 2

    def weight(self, dtype: torch.dtype) -> torch.Tensor:
        key = (dtype,) + tuple((p.device, p.data_ptr(), p._version)
                               for p in (self.weight_g, self.weight_v))
        cached = getattr(self, "_weight_cache", None)
        if torch.is_grad_enabled() or cached is None or cached[0] != key:
            acc = head_dtype(dtype)
            v = self.weight_v.to(acc)
            norm = torch.sqrt((v * v).sum(dim=(1, 2, 3), keepdim=True) + 1e-12)
            cached = (key, (v * (self.weight_g.to(acc) / norm)).to(dtype))
            if not torch.is_grad_enabled():
                self._weight_cache = cached
        return cached[1]

    def forward(self, x):
        return F.conv2d(x, self.weight(x.dtype), compute_weight(self.bias, x.dtype),
                        padding=self.padding)


class ResBlock(nn.Module):
    """WDSR residual body; the skip is added by the caller. Key: module.{0,2}."""

    def __init__(self, cin: int, hidden: int, cout: int):
        super().__init__()
        self.module = nn.Sequential(WNConv(cin, hidden), nn.ReLU(), WNConv(hidden, cout))

    def forward(self, x):
        return self.module(x)


class ContextAdjustmentLayer(nn.Module):
    """WDSR-style refinement of the disparity and the occlusion head
    (`blocks.py:194-229`). Keys: in_conv, layers.{i}.module.{0,2}, out_conv,
    occ_head.{0,1,3,4} (WNConv) and occ_head.6 (conv)."""

    def __init__(self, num_blocks: int = 8, feature_dim: int = 16, expansion: int = 3):
        super().__init__()
        f = feature_dim
        self.in_conv = nn.Conv2d(4, f, 3, padding=1)
        self.layers = nn.ModuleList([ResBlock(f + 1, f * expansion, f) for _ in range(num_blocks)])
        self.out_conv = nn.Conv2d(f, 1, 3, padding=1)
        self.occ_head = nn.Sequential(WNConv(4, f), WNConv(f, f), nn.ReLU(), WNConv(f, f),
                                      WNConv(f, f), nn.ReLU(), nn.Conv2d(f, 1, 3, padding=1),
                                      nn.Sigmoid())

    def forward(self, disp_raw, occ_raw, img, dtype: torch.dtype):
        """disp_raw, occ_raw [B,1,H,W] and img [B,3,H,W] (any float dtype) →
        (disp [B,1,H,W] in disp_raw's dtype promoted with `dtype`, occ [B,1,H,W]
        in `dtype`); the convs run in `dtype`."""
        feat = run_conv(torch.cat([disp_raw, img], dim=1).to(dtype), self.in_conv)
        for layer in self.layers:
            feat = feat + layer(torch.cat([disp_raw.to(dtype), feat], dim=1))
        disp = disp_raw + run_conv(feat, self.out_conv)
        o = torch.cat([occ_raw, img], dim=1).to(dtype)
        for m in self.occ_head:
            o = run_conv(o, m) if isinstance(m, nn.Conv2d) else m(o)
        return disp, o
