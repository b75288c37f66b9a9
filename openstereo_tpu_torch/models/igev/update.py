"""IGEV's multi-scale ConvGRU update, NCHW (counterpart of `openstereo_tpu/models/igev/update.py`).

A conv runs in the dtype of the GRU's hidden state (the model's compute
dtype): inputs of another dtype (the f32 disparity, and the motion features
that carry it) are cast to it first, as flax's `nn.Conv(dtype=)` casts
them. The JAX package's `SplitPointwise` applies the motion encoder's 1×1
conv block by block to skip a TPU relayout; it computes the conv on the
concatenated lookups, which is what runs here. Attribute names follow the
reference's `update_block` as `torch_convert.py:_update_block` reads it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import resize_linear_align_corners
from ..layers import head_dtype, run_conv


def pool2x(x: torch.Tensor) -> torch.Tensor:
    """3×3 average pool, stride 2, padding 1 counted (`update.py:15`), in at
    least f32 and rounded once (ROADMAP §3, 3e)."""
    return F.avg_pool2d(x.to(head_dtype(x.dtype)), 3, 2, 1, count_include_pad=True).to(x.dtype)


def interp_to(x: torch.Tensor, dest: torch.Tensor) -> torch.Tensor:
    """Bilinear align_corners=True resize to dest's H, W (`update.py:21`)."""
    return resize_linear_align_corners(x, tuple(dest.shape[2:]))


class ConvGRU(nn.Module):
    """Gated conv recurrence with context biases (`update.py:26`): z, r =
    sigmoid(conv([h, x]) + cz, cr), q = tanh(conv([r·h, x]) + cq), h' =
    (1 - z)·h + z·q. Keys: convz, convr, convq."""

    def __init__(self, hidden_dim: int, input_dim: int):
        super().__init__()
        self.convz = nn.Conv2d(hidden_dim + input_dim, hidden_dim, 3, padding=1)
        self.convr = nn.Conv2d(hidden_dim + input_dim, hidden_dim, 3, padding=1)
        self.convq = nn.Conv2d(hidden_dim + input_dim, hidden_dim, 3, padding=1)

    def forward(self, h, context, *x_list):
        x = torch.cat([t.to(h.dtype) for t in x_list], dim=1)
        hx = torch.cat([h, x], dim=1)
        cz, cr, cq = context if context is not None else (0.0, 0.0, 0.0)
        z = torch.sigmoid(run_conv(hx, self.convz) + cz)
        r = torch.sigmoid(run_conv(hx, self.convr) + cr)
        q = torch.tanh(run_conv(torch.cat([r * h, x], dim=1), self.convq) + cq)
        return (1 - z) * h + z * q


class BasicMotionEncoder(nn.Module):
    """Lookups + the current disparity → `out` motion features, the disparity
    last (`update.py:82`). Its convs run in the lookups' dtype. The widths
    are IGEV's by default: `corr` (convc1, convc2) 64, 64, `disp` (convd1,
    convd2) 64, 64, out 128; IGEV-RT's encoder has out 96
    (`igev_rt.py:43`), IGEV++'s `BasicDispEncoder` corr 128, 96 and disp
    32, 32 (`igevpp.py:114`), FoundationStereo's corr 256, 256 (its fusing
    conv `fuse_kernel` 3, FastFoundationStereo's 1; `foundationstereo/
    blocks.py:386-404`). Keys: convc1, convc2, convd1, convd2, conv."""

    def __init__(self, cor_planes: int, corr: Sequence[int] = (64, 64),
                 disp: Sequence[int] = (64, 64), out: int = 128, fuse_kernel: int = 3):
        super().__init__()
        self.convc1 = nn.Conv2d(cor_planes, corr[0], 1)
        self.convc2 = nn.Conv2d(corr[0], corr[1], 3, padding=1)
        self.convd1 = nn.Conv2d(1, disp[0], 7, padding=3)
        self.convd2 = nn.Conv2d(disp[0], disp[1], 3, padding=1)
        self.conv = nn.Conv2d(corr[1] + disp[1], out - 1, fuse_kernel, padding=fuse_kernel // 2)

    def forward(self, disp, geo):
        cor = F.relu(run_conv(geo, self.convc1))
        cor = F.relu(run_conv(cor, self.convc2))
        d = F.relu(run_conv(disp.to(geo.dtype), self.convd1))
        d = F.relu(run_conv(d, self.convd2))
        out = F.relu(run_conv(torch.cat([cor, d], dim=1), self.conv))
        return torch.cat([out, disp], dim=1)  # the wider of the two dtypes, as jnp's


class DispHead(nn.Module):
    """Two 3×3 convs with a relu between (`update.py:107`). Keys: conv1, conv2."""

    def __init__(self, input_dim: int, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 1, 3, padding=1)

    def forward(self, x):
        return run_conv(F.relu(run_conv(x, self.conv1)), self.conv2)


class BasicMultiUpdateBlock(nn.Module):
    """The three-scale GRU cascade with slow-fast flags (`update.py:120`).
    hidden_dims are ordered [1/16, 1/8, 1/4]: net[0] (1/4) has hidden_dims[2]
    channels. `encoder` is the motion encoder (IGEV's `BasicMotionEncoder`
    over `cor_planes` by default) and `mask_ch` the width of mask_feat_4 (32;
    IGEV++ 64). Keys: encoder, gru04, gru08, gru16, disp_head,
    mask_feat_4.0."""

    def __init__(self, hidden_dims: Sequence[int] = (128, 128, 128), n_gru_layers: int = 3,
                 cor_planes: int = 162, encoder: Optional[nn.Module] = None, mask_ch: int = 32):
        super().__init__()
        hd = list(hidden_dims)
        self.n_gru_layers = n_gru_layers
        self.encoder = encoder if encoder is not None else BasicMotionEncoder(cor_planes)
        self.gru04 = ConvGRU(hd[2], self.encoder.conv.out_channels + 1
                             + hd[1] * (n_gru_layers > 1))
        self.gru08 = ConvGRU(hd[1], hd[0] * (n_gru_layers == 3) + hd[2])
        self.gru16 = ConvGRU(hd[0], hd[1])
        self.disp_head = DispHead(hd[2], 256)
        self.mask_feat_4 = nn.Sequential(nn.Conv2d(hd[2], mask_ch, 3, padding=1), nn.ReLU())

    def forward(self, net, inp, geo: Optional[torch.Tensor] = None,
                disp: Optional[torch.Tensor] = None, iter04: bool = True, iter08: bool = True,
                iter16: bool = True, update: bool = True):
        net = list(net)
        if iter16:
            net[2] = self.gru16(net[2], inp[2], pool2x(net[1]))
        if iter08:
            extra = [pool2x(net[0])]
            if self.n_gru_layers > 2:
                extra.append(interp_to(net[2], net[1]))
            net[1] = self.gru08(net[1], inp[1], *extra)
        if iter04:
            extra = [self.encoder(disp, geo)]
            if self.n_gru_layers > 1:
                extra.append(interp_to(net[1], net[0]))
            net[0] = self.gru04(net[0], inp[0], *extra)
        if not update:
            return net
        delta_disp = self.disp_head(net[0])
        mask_feat_4 = F.relu(run_conv(net[0], self.mask_feat_4[0]))
        return net, mask_feat_4, delta_disp
