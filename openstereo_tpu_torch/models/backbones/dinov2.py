"""DINOv2 vision transformer, NCHW in, tokens out (counterpart of
`openstereo_tpu/models/backbones/dinov2.py`): the frozen trunk of
DepthAnythingV2, which FoundationStereo reads through a DPT head.

Tokens ride [B, N, C], the class token first, the patch tokens row-major over
the patch grid. The attention is the JAX package's plain matmul form: q·kᵀ,
a softmax in at least f32 cast to v's dtype, p·v; no fused attention, whose
rounding differs. The 37×37 position table is resized for other patch grids
by PyTorch's bicubic (A = -0.75) at the scale (n + 0.1) / 37 of the reference,
as two interpolation matrices in f32 (`_torch_bicubic_matrix`, the JAX
package's numpy helper, copied). Keys follow the torch hub dinov2_vitX14
state_dict as `openstereo_tpu/utils/torch_convert.py:_dino_vit` reads it
(`patch_embed.proj`, `blocks.i.{norm1,attn.qkv,attn.proj,ls1.gamma,norm2,
mlp.fc1,mlp.fc2,ls2.gamma}`, `norm`, `cls_token`, `pos_embed`); the
reference's `mask_token` (masked-image modelling only) is not held.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..layers import gelu, head_dtype, layer_norm, linear, run_conv

VIT_CONFIGS = {
    # name: (embed_dim, depth, num_heads)
    "vits": (384, 12, 6),
    "vitb": (768, 12, 12),
    "vitl": (1024, 24, 16),
}

# the DPT head's tap layers per trunk (`dinov2.py:37-41`)
INTERMEDIATE_LAYERS = {
    "vits": (2, 5, 8, 11),
    "vitb": (2, 5, 8, 11),
    "vitl": (4, 11, 17, 23),
}

PATCH = 14
POS_GRID = 37  # 518 // 14


@lru_cache(maxsize=None)
def _torch_bicubic_matrix(n_in: int, n_out: int, scale: float) -> np.ndarray:
    """[n_out, n_in] F.interpolate(mode='bicubic', align_corners=False) matrix
    for a given scale_factor (A = -0.75, src = (dst + 0.5)/scale - 0.5, edge
    clamp), f64 rounded to f32 (`dinov2.py:44-64`)."""
    a = -0.75

    def kernel(x):
        x = abs(x)
        if x <= 1.0:
            return (a + 2) * x**3 - (a + 3) * x**2 + 1
        if x < 2.0:
            return a * x**3 - 5 * a * x**2 + 8 * a * x - 4 * a
        return 0.0

    m = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        src = (i + 0.5) / scale - 0.5
        j0 = int(np.floor(src)) - 1
        for j in range(j0, j0 + 4):
            m[i, min(max(j, 0), n_in - 1)] += kernel(src - j)
    return m.astype(np.float32)


def resized_pos_embed(pos: torch.Tensor, h0: int, w0: int, n: int = POS_GRID) -> torch.Tensor:
    """[1, 1+n·n, C] → [1, 1+h0·w0, C]: the patch rows bicubic-resized at the
    scales (h0 + 0.1)/n and (w0 + 0.1)/n, rows then columns, in pos's dtype
    (`dinov2.py:166-176`); the class row kept."""
    if h0 == n and w0 == n:
        return pos
    dim = pos.shape[-1]
    mh, mw = (torch.from_numpy(_torch_bicubic_matrix(n, m, (m + 0.1) / n)).to(pos.device,
                                                                              pos.dtype)
              for m in (h0, w0))
    grid = pos[0, 1:].reshape(n, n, dim)
    out = torch.einsum("hi,iwc->hwc", mh, grid)
    out = torch.einsum("hwc,jw->hjc", out, mw)
    return torch.cat([pos[:, :1], out.reshape(1, h0 * w0, dim)], dim=1)


class PatchEmbed(nn.Module):
    """14×14 stride-14 conv (key: proj)."""

    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, PATCH, PATCH)


class ViTAttention(nn.Module):
    """Packed-qkv multi-head attention (`dinov2.py:86-105`). Keys: qkv, proj."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        hd = c // self.num_heads
        qkv = linear(x, self.qkv).reshape(b, n, 3, self.num_heads, hd)
        q, k, v = qkv[:, :, 0] * hd ** -0.5, qkv[:, :, 1], qkv[:, :, 2]
        attn = torch.einsum("bnhc,bmhc->bhnm", q, k)
        p = torch.softmax(attn.to(head_dtype(x.dtype)), dim=-1).to(v.dtype)
        out = torch.einsum("bhnm,bmhc->bnhc", p, v).reshape(b, n, c)
        return linear(out, self.proj)


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))


class Mlp(nn.Module):
    """fc1, exact GELU, fc2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(gelu(linear(x, self.fc1)), self.fc2)


class ViTBlock(nn.Module):
    """Pre-norm block with LayerScale (`dinov2.py:108-128`). Keys: norm1, attn,
    ls1.gamma, norm2, mlp.fc1, mlp.fc2, ls2.gamma."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = ViTAttention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.attn(layer_norm(x, self.norm1))
        x = x + y * self.ls1.gamma.to(y.dtype)
        y = self.mlp(layer_norm(x, self.norm2))
        return x + y * self.ls2.gamma.to(y.dtype)


class DinoViT(nn.Module):
    """DINOv2 trunk (`dinov2.py:131-186`): images [B,3,H,W], H and W multiples
    of 14 → for each tap layer (tokens [B, h0·w0, C], class token [B, C]),
    normed by the final LayerNorm."""

    def __init__(self, variant: str = "vits", taps: Optional[Sequence[int]] = None):
        super().__init__()
        dim, depth, heads = VIT_CONFIGS[variant]
        self.taps = tuple(taps) if taps is not None else INTERMEDIATE_LAYERS[variant]
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, POS_GRID * POS_GRID + 1, dim))
        self.patch_embed = PatchEmbed(dim)
        self.blocks = nn.ModuleList(ViTBlock(dim, heads) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        b, _, h, w = x.shape
        h0, w0 = h // PATCH, w // PATCH
        tokens = run_conv(x, self.patch_embed.proj).flatten(2).transpose(1, 2)
        dim = tokens.shape[-1]
        tokens = torch.cat([self.cls_token.to(tokens.dtype).expand(b, 1, dim), tokens], dim=1)
        tokens = tokens + resized_pos_embed(self.pos_embed, h0, w0).to(tokens.dtype)
        outs = []
        for i, blk in enumerate(self.blocks[:max(self.taps) + 1]):
            tokens = blk(tokens)
            if i in self.taps:
                normed = layer_norm(tokens, self.norm)
                outs.append((normed[:, 1:], normed[:, 0]))
        return outs
