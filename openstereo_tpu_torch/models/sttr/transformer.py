"""STTR epipolar transformer: alternating self- and cross-attention with a
relative sine positional encoding (counterpart of
`openstereo_tpu/models/sttr/transformer.py`).

Sequences live as [B', W, C], one epipolar line per batch element. Attribute
names follow the reference STTR state_dict (`self_attn_layers.{i}.self_attn.
in_proj_weight`, `cross_attn_layers.{i}.norm2`, `transformer.norm`).

`MultiheadAttentionRelative` has two paths. With `use_kernels` on and a
positional table (W == Wk), it runs the relative attention through K4 (the
CUDA kernel; on the CPU its plain version): `ops.rel_attention` in eval,
`ops.rel_attention_trainable` (K4's forward, the analytic backward) in
training. With `use_kernels` off it runs the einsum decomposition against
the gathered [W, W, C] tables, as the JAX package's non-Pallas path does,
under autograd in training.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import rel_attention, rel_attention_trainable
from ...ops.rel_attention import rel_index
from ..layers import compute_weight, head_dtype

_POS_CACHE: Dict[tuple, torch.Tensor] = {}


def sine_pos_encoding(w: int, channels: int, scale: float, dtype: torch.dtype,
                      device: torch.device) -> torch.Tensor:
    """Relative 1D sine table [2W-1, C] (`transformer.py:27-44`): distances run
    from (W-1)·scale down to (1-W)·scale; sin on even channels, cos on odd.

    Built in float64 with numpy and rounded to f32, then to `dtype`, as the
    JAX package does (f32 position arguments would cost ~1e-5 in the sines);
    an f64 table keeps the f64 values, as the JAX package's under x64.
    Cached per (W, C, scale, dtype, device).
    """
    key = (w, channels, float(scale), dtype, torch.device(device))
    if key not in _POS_CACHE:
        x_embed = np.linspace((w - 1) * scale, -(w - 1) * scale, 2 * w - 1)
        dim_t = np.arange(channels, dtype=np.float64)
        dim_t = 10000.0 ** (2 * (dim_t // 2) / channels)
        pos = x_embed[:, None] / dim_t[None, :]
        out = np.empty_like(pos)
        out[:, 0::2] = np.sin(pos[:, 0::2])
        out[:, 1::2] = np.cos(pos[:, 1::2])
        if dtype != torch.float64:
            out = out.astype(np.float32)
        _POS_CACHE[key] = torch.from_numpy(out).to(device, dtype)
    return _POS_CACHE[key]


def rel_pos_matrix(table: torch.Tensor, w: int) -> torch.Tensor:
    """Gather [W, W, C] from a [2W-1, C] table: entry (i, j) is row W-1-i+j
    (`transformer.py:47-53`)."""
    return table[rel_index(w, table.device)]


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm with statistics in at least f32, as flax; cast back to x's dtype."""
    return F.layer_norm(x.to(head_dtype(x.dtype)), norm.normalized_shape, norm.weight,
                        norm.bias, norm.eps).to(x.dtype)


def rel_attention_eager(q, k, v, ke, qe, nheads: int, masked: bool = False,
                        attn_mask: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The eager path's attention (`transformer.py:115-136`) on projected
    inputs, in their dtype: q (pre-scaled), k, v [B,W,E]; ke, qe (pre-scaled)
    [2W-1,E] or None. Logits stay in the compute dtype; `masked` adds a -inf
    upper triangle (in f32, which promotes them); the softmax runs in at least
    f32. Returns (out [B,W,E], raw = the logits summed over heads [B,W,W]).
    """
    b, w, e = q.shape
    wk = k.shape[1]
    hd = e // nheads
    qh = q.reshape(b, w, nheads, hd)
    kh = k.reshape(b, wk, nheads, hd)
    vh = v.reshape(b, wk, nheads, hd)
    attn = torch.einsum("bwhc,bvhc->bhwv", qh, kh)
    if ke is not None:
        k_r = rel_pos_matrix(ke, w).reshape(w, wk, nheads, hd)
        q_r = rel_pos_matrix(qe, w).reshape(w, wk, nheads, hd)
        attn = attn + torch.einsum("bwhc,wvhc->bhwv", qh, k_r)
        attn = attn + torch.einsum("bvhc,wvhc->bhwv", kh, q_r)
    if masked:
        attn_mask = torch.triu(torch.full((w, w), float("-inf"), device=q.device), 1)
    if attn_mask is not None:
        attn = attn + attn_mask[None, None]
    raw = attn.sum(dim=1)
    p = torch.softmax(attn.to(head_dtype(q.dtype)), dim=-1).to(v.dtype)
    out = torch.einsum("bhwv,bvhc->bwhc", p, vh).reshape(b, w, e)
    return out, raw


class MultiheadAttentionRelative(nn.Module):
    """Multi-head attention with relative-position terms (`transformer.py:56-138`).

    Parameters as the reference: packed in_proj_weight [3C, C] and
    in_proj_bias [3C], whose row thirds are q, k and v, and out_proj.
    """

    use_kernels = True

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def proj(self, x: torch.Tensor, which: int) -> torch.Tensor:
        """The q (0), k (1) or v (2) projection, bias included."""
        e = self.embed_dim
        rows = slice(which * e, (which + 1) * e)
        return F.linear(x, compute_weight(self.in_proj_weight, x.dtype)[rows],
                        compute_weight(self.in_proj_bias, x.dtype)[rows])

    def forward(self, query, key, value, pos_table=None, attn_mask=None,
                masked_last: bool = False, need_raw: bool = True):
        e, nh = self.embed_dim, self.num_heads
        scaling = (e // nh) ** -0.5
        q, k, v = self.proj(query, 0), self.proj(key, 1), self.proj(value, 2)
        w, wk = q.shape[1], k.shape[1]
        if pos_table is not None and w != wk:
            raise ValueError(f"relative attention needs W == Wk, got {w} and {wk}")
        ke = qe = None
        if pos_table is not None:
            ke = self.proj(pos_table, 1)
            qe = self.proj(pos_table, 0) * scaling
        if self.use_kernels and pos_table is not None:
            # the kernel takes only the causal mask (as the TPU kernel)
            if attn_mask is not None:
                raise ValueError("the rel_attention kernel takes no explicit attn_mask; "
                                 "use masked_last or turn use_kernels off")
            if self.training:
                # the kernel takes contiguous inputs (no-op copies for F.linear's outputs)
                args = [t.contiguous() for t in (q * scaling, k, v, ke, qe)]
                out, raw = rel_attention_trainable(*args, nh, masked_last, need_raw)
            else:
                out, raw = rel_attention(q * scaling, k, v, ke, qe, nh, masked_last, need_raw)
        else:
            out, raw = rel_attention_eager(q * scaling, k, v, ke, qe, nh, masked_last, attn_mask)
        out = F.linear(out, compute_weight(self.out_proj.weight, out.dtype),
                       compute_weight(self.out_proj.bias, out.dtype))
        return out, raw


class SelfAttnLayer(nn.Module):
    """Pre-norm self-attention with a residual (`transformer.py:141-154`)."""

    def __init__(self, hidden_dim: int, nhead: int):
        super().__init__()
        self.self_attn = MultiheadAttentionRelative(hidden_dim, nhead)
        self.norm1 = nn.LayerNorm(hidden_dim, eps=1e-5)

    def forward(self, feat, pos_table):
        y = layer_norm(feat, self.norm1)
        y, _ = self.self_attn(y, y, y, pos_table=pos_table, need_raw=False)
        return feat + y


class CrossAttnLayer(nn.Module):
    """Right attends left, then left attends the updated right, with one
    attention module and a shared norm1 (`transformer.py:157-187`)."""

    def __init__(self, hidden_dim: int, nhead: int):
        super().__init__()
        self.cross_attn = MultiheadAttentionRelative(hidden_dim, nhead)
        self.norm1 = nn.LayerNorm(hidden_dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(hidden_dim, eps=1e-5)

    def forward(self, feat_left, feat_right, pos_table, pos_table_flipped, last_layer: bool):
        left2 = layer_norm(feat_left, self.norm1)
        right2 = layer_norm(feat_right, self.norm1)
        upd_right, _ = self.cross_attn(right2, left2, left2, pos_table=pos_table_flipped,
                                       need_raw=False)
        feat_right = feat_right + upd_right
        right2 = layer_norm(feat_right, self.norm2)
        upd_left, raw = self.cross_attn(left2, right2, right2, pos_table=pos_table,
                                        masked_last=last_layer, need_raw=last_layer)
        return feat_left + upd_left, feat_right, raw


class Transformer(nn.Module):
    """Alternating self/cross stack → attention [N,H',W',W'] (`transformer.py:190-226`).

    `norm` is the reference's final LayerNorm, which it builds and never
    applies; it is kept so that reference checkpoints load with strict=True.
    """

    def __init__(self, hidden_dim: int = 128, nhead: int = 8, num_attn_layers: int = 6):
        super().__init__()
        self.self_attn_layers = nn.ModuleList([SelfAttnLayer(hidden_dim, nhead)
                                               for _ in range(num_attn_layers)])
        self.cross_attn_layers = nn.ModuleList([CrossAttnLayer(hidden_dim, nhead)
                                                for _ in range(num_attn_layers)])
        self.norm = nn.LayerNorm(hidden_dim)

    def forward(self, feat_left, feat_right, pos_scale: float = 1.0):
        """feat_left/right [N,C,H',W'] (already sampled) → [N,H',W',W']."""
        n, c, h, w = feat_left.shape
        fl = feat_left.permute(0, 2, 3, 1).reshape(n * h, w, c)
        fr = feat_right.permute(0, 2, 3, 1).reshape(n * h, w, c)
        pos_table = sine_pos_encoding(w, c, pos_scale, fl.dtype, fl.device)
        pos_table_flipped = pos_table.flip(0)

        raw = None
        last = len(self.self_attn_layers) - 1
        for i, (self_layer, cross_layer) in enumerate(zip(self.self_attn_layers,
                                                          self.cross_attn_layers)):
            feat = self_layer(torch.cat([fl, fr], dim=0), pos_table)
            fl, fr = feat[:n * h], feat[n * h:]
            fl, fr, raw = cross_layer(fl, fr, pos_table, pos_table_flipped, i == last)
        return raw.reshape(n, h, w, w)
