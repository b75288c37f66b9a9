"""EdgeNeXt-small trunk, NCHW (counterpart of `openstereo_tpu/models/backbones/edgenext.py`):
the CNN branch of FoundationStereo's and FastFoundationStereo's features.

Four stages at 1/4..1/32, dims (48, 96, 160, 304), depths (3, 3, 9, 3),
local kernels (3, 5, 7, 9); each of stages 2-4 closes with an SDTA block:
a split-depthwise cascade, then cross-covariance attention over the channel
axis (L2-normalised q and k, a learned temperature) and an MLP, each with
LayerScale. The depthwise convs run NCHW; the LayerNorms, the MLPs and the
attention run on channels-last tokens, as timm's blocks do. Keys follow
timm's `edgenext_small` as `openstereo_tpu/utils/torch_convert.py:_edgenext`
reads them: stem.{0,1}, stages.s.downsample.{0,1}, stages.s.blocks.i.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..layers import gelu, head_dtype, layer_norm, linear, run_conv


def channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def channels_first(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class Mlp(nn.Module):
    """fc1 (dim → 4·dim), exact GELU, fc2 (keys: fc1, fc2)."""

    def __init__(self, dim: int, expan_ratio: int = 4):
        super().__init__()
        self.fc1 = nn.Linear(dim, dim * expan_ratio)
        self.fc2 = nn.Linear(dim * expan_ratio, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(gelu(linear(x, self.fc1)), self.fc2)


class ConvEncoder(nn.Module):
    """dw k×k → LN → MLP → LayerScale, plus x (`edgenext.py:35-52`). Keys:
    conv_dw, norm, mlp.fc1, mlp.fc2, gamma."""

    def __init__(self, dim: int, kernel: int = 7, expan_ratio: int = 4):
        super().__init__()
        self.conv_dw = nn.Conv2d(dim, dim, kernel, padding=kernel // 2, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, expan_ratio)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.mlp(layer_norm(channels_last(run_conv(x, self.conv_dw)), self.norm))
        return x + channels_first(y * self.gamma.to(y.dtype))


def l2_unit(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x / max(‖x‖, 1e-12) along `dim` in x's dtype (torch's F.normalize, as
    `edgenext.py:75-76` writes it): the squares and their sum in at least
    f32, the sum rounded to x's dtype, its sqrt in x's dtype, as the jitted
    `jnp.linalg.norm` rounds (CoEx's `cosine_normalize` does the same)."""
    xf = x.to(head_dtype(x.dtype))
    norm = torch.sqrt((xf * xf).sum(dim=dim, keepdim=True).to(x.dtype))
    return x / norm.clamp(min=1e-12)


class XCA(nn.Module):
    """Cross-covariance attention over [B, N, C] (`edgenext.py:55-83`): per head
    a softmax over the C/nh × C/nh cosine similarities of q and k along the
    tokens, scaled by a learned temperature. Keys: temperature, qkv, proj."""

    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        nh = self.num_heads
        qkv = linear(x, self.qkv).reshape(b, n, 3, nh, c // nh).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # [B, nh, N, hd]
        attn = torch.einsum("bhnc,bhnd->bhcd", l2_unit(q, 2), l2_unit(k, 2))
        attn = attn * self.temperature.to(q.dtype)
        p = torch.softmax(attn.to(head_dtype(x.dtype)), dim=-1).to(v.dtype)
        out = torch.einsum("bhcd,bhnd->bhnc", p, v)
        return linear(out.transpose(1, 2).reshape(b, n, c), self.proj)


@lru_cache(maxsize=None)
def fourier_pos_table(h: int, w: int, hidden_dim: int = 32,
                      temperature: float = 10000.0) -> np.ndarray:
    """timm PositionalEncodingFourier's table before its projection, [h·w,
    2·hidden] f32 (`edgenext.py:138-158`, copied): DETR-style normalised
    coordinates, (sin, cos) pairs per frequency, the y block then the x block."""
    eps = 1e-6
    scale = 2 * np.pi
    y = (np.arange(1, h + 1, dtype=np.float64) / (h + eps) * scale)
    x = (np.arange(1, w + 1, dtype=np.float64) / (w + eps) * scale)
    dim_t = temperature ** (2 * (np.arange(hidden_dim) // 2) / hidden_dim)

    def enc(v):
        p = v[:, None] / dim_t[None, :]
        out = np.empty_like(p)
        out[:, 0::2] = np.sin(p[:, 0::2])
        out[:, 1::2] = np.cos(p[:, 1::2])
        return out

    py = np.repeat(enc(y), w, axis=0)
    px = np.tile(enc(x), (h, 1))
    return np.concatenate([py, px], axis=1).astype(np.float32)


class PositionalEncodingFourier(nn.Module):
    """The learned 1×1 projection of the Fourier table (key: token_projection)."""

    def __init__(self, dim: int, hidden_dim: int = 32):
        super().__init__()
        self.token_projection = nn.Conv2d(2 * hidden_dim, dim, 1)

    def forward(self, h: int, w: int, like: torch.Tensor) -> torch.Tensor:
        """[h·w, dim] in like's dtype (flax's Dense on the table)."""
        table = torch.from_numpy(fourier_pos_table(h, w)).to(like.device, like.dtype)
        return linear(table, self.token_projection)


class SDTAEncoder(nn.Module):
    """Split-depthwise cascade + transposed attention + MLP (`edgenext.py:86-135`):
    the block's output is x + gamma·MLP(LN(tokens after the attention)); the
    attended tokens feed the MLP only. Keys: convs.i, pos_embd.token_projection
    (stage 2), norm_xca, gamma_xca, xca, norm, mlp, gamma."""

    def __init__(self, dim: int, scales: int = 2, num_heads: int = 8, expan_ratio: int = 4,
                 use_pos_emb: bool = False):
        super().__init__()
        self.width = math.ceil(dim / scales)
        n_splits = math.ceil(dim / self.width)
        self.convs = nn.ModuleList(nn.Conv2d(self.width, self.width, 3, padding=1,
                                             groups=self.width) for _ in range(n_splits - 1))
        self.pos_embd = PositionalEncodingFourier(dim) if use_pos_emb else None
        self.norm_xca = nn.LayerNorm(dim, eps=1e-6)
        self.gamma_xca = nn.Parameter(torch.full((dim,), 1e-6))
        self.xca = XCA(dim, num_heads)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, expan_ratio)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        splits = torch.split(x, self.width, dim=1)
        outs, prev = [], None
        for sp, conv in zip(splits[:-1], self.convs):
            prev = run_conv(sp if prev is None else sp + prev, conv)
            outs.append(prev)
        outs.append(splits[-1])
        tok = torch.cat(outs, dim=1).flatten(2).transpose(1, 2)  # [B, h·w, C]
        if self.pos_embd is not None:
            tok = tok + self.pos_embd(h, w, tok)
        tok = tok + self.gamma_xca.to(tok.dtype) * self.xca(layer_norm(tok, self.norm_xca))
        z = self.mlp(layer_norm(tok, self.norm))
        return x + (self.gamma.to(z.dtype) * z).transpose(1, 2).reshape(b, c, h, w)


class Stage(nn.Module):
    """downsample (LN over channels, 2×2 stride-2 conv; not in stage 0), then
    the local blocks and the SDTA blocks. Keys: downsample.{0,1}, blocks.i."""

    def __init__(self, cin: int, dim: int, depth: int, kernel: int, n_global: int, scales: int,
                 pos_emb: bool, first: bool):
        super().__init__()
        self.downsample = None if first else nn.Sequential(nn.LayerNorm(cin, eps=1e-6),
                                                           nn.Conv2d(cin, dim, 2, 2))
        self.blocks = nn.ModuleList(
            [ConvEncoder(dim, kernel) for _ in range(depth - n_global)]
            + [SDTAEncoder(dim, scales, use_pos_emb=pos_emb) for _ in range(n_global)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample is not None:
            x = run_conv(layer_norm(x, self.downsample[0], dim=1), self.downsample[1])
        for blk in self.blocks:
            x = blk(x)
        return x


class EdgeNeXtFeatures(nn.Module):
    """The four-stage trunk (`edgenext.py:161-192`), `trunk`: [B,3,H,W] → [c4 @1/4,
    c8 @1/8, c16 @1/16, c32 @1/32]; FoundationStereo's and FastFoundationStereo's
    feature modules extend it. Keys: stem.0 (4×4 stride-4 conv), stem.1 (LN
    over channels), stages.s."""

    def __init__(self, dims: Sequence[int] = (48, 96, 160, 304),
                 depths: Sequence[int] = (3, 3, 9, 3), kernels: Sequence[int] = (3, 5, 7, 9),
                 global_blocks: Sequence[int] = (0, 1, 1, 1), scales: Sequence[int] = (2, 2, 3, 4),
                 pos_emb: Sequence[bool] = (False, True, False, False)):
        super().__init__()
        self.stem = nn.Sequential(nn.Conv2d(3, dims[0], 4, 4), nn.LayerNorm(dims[0], eps=1e-6))
        self.stages = nn.ModuleList(
            Stage(dims[max(si - 1, 0)], dims[si], depths[si], kernels[si], global_blocks[si],
                  scales[si], pos_emb[si], si == 0) for si in range(len(dims)))

    def trunk(self, x: torch.Tensor) -> List[torch.Tensor]:
        """The four stages' outputs (the subclasses' `forward` decodes them)."""
        x = layer_norm(run_conv(x, self.stem[0]), self.stem[1], dim=1)
        outs = []
        for stage in self.stages:
            x = stage(x)
            outs.append(x)
        return outs
