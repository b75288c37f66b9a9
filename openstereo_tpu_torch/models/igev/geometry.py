"""IGEV's combined geometry-encoding-volume lookup, by gather (counterpart of
`openstereo_tpu/models/igev/geometry.py`).

Every GRU iteration samples (a) the aggregated geometry volume along D and
(b) the all-pairs correlation along W at 2r+1 taps around the current
disparity, over a pyramid of `num_levels` levels. A lookup is linear
interpolation along the last axis with zero padding, per level: what
`grid_sample(align_corners=True, padding_mode="zeros")` gives on pixel
coordinates. The JAX package computes it as a hat-matrix contraction and
merges the levels under a block mask, both to keep a TPU's matrix unit
busy; here each pyramid is one gather per tap over its concatenated levels,
with the same results. The lookup layout is the JAX package's, the lookup
axis last: volumes [B,H,W,C,L], positions [B,H,W,T], results [B,H,W,C·T]
(channel-major, the order the motion encoder's 1×1 conv weights expect).
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..layers import head_dtype


def _taps(pos: torch.Tensor):
    """(index, weight) of the two taps of each position, the weights as the
    JAX package's hat function relu(1 - |pos - l|) gives them in pos's dtype."""
    x0 = torch.floor(pos)
    return ((x0, 1.0 - (pos - x0)), (x0 + 1.0, 1.0 - ((x0 + 1.0) - pos)))


def _gather_lerp(flat: torch.Tensor, pos: torch.Tensor, lo: torch.Tensor,
                 hi: torch.Tensor) -> torch.Tensor:
    """flat [N,C,L] sampled at pos [N,T]: the taps at index l with lo <= l <
    hi (per position) weigh in, the others are zero → [N,C,T] in flat's
    dtype. The weights are rounded to flat's dtype, each product and the
    sum taken in at least f32, then rounded once."""
    n, c, _ = flat.shape
    acc = head_dtype(flat.dtype)
    out = None
    for idx, wgt in _taps(pos):
        valid = (idx >= lo) & (idx < hi)
        wgt = torch.where(valid, wgt, torch.zeros_like(wgt)).to(flat.dtype).to(acc)
        i = torch.where(valid, idx, lo).to(torch.int64)
        g = torch.gather(flat, 2, i[:, None, :].expand(n, c, i.shape[-1])).to(acc)
        term = g * wgt[:, None, :]
        out = term if out is None else out + term
    return out.to(flat.dtype)


def lookup_1d(vol: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """vol [B,H,W,C,L] linearly interpolated along L at pos [B,H,W,T] (pixel
    coordinates; taps outside [0, L-1] are zero) → [B,H,W,C·T] in vol's
    dtype (counterpart of `geometry.py:25`)."""
    b, h, w, c, length = vol.shape
    t = pos.shape[-1]
    p = pos.reshape(-1, t)
    lo, hi = torch.zeros_like(p), torch.full_like(p, float(length))
    return _gather_lerp(vol.reshape(-1, c, length), p, lo, hi).reshape(b, h, w, c * t)


class MultiLookup:
    """All pyramid levels sampled as one gather per tap (counterpart of
    `geometry.py:46`): the levels are concatenated along L, each position is
    offset into its level's segment, and a tap outside its own level is
    zero, so that a level never reads its neighbour's values. The levels
    share C; positions are pixel coordinates in each level's own
    [0, L_i - 1] frame."""

    def __init__(self, vols: Sequence[torch.Tensor]):
        self.sizes = [int(v.shape[-1]) for v in vols]
        self.offsets = [sum(self.sizes[:i]) for i in range(len(vols))]
        self.cat = torch.cat(list(vols), dim=-1)

    def __call__(self, pos_list: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """pos_list[i]: [B,H,W,T] → per level [B,H,W,C·T]."""
        b, h, w, c, ltot = self.cat.shape
        t = pos_list[0].shape[-1]
        pos = torch.cat([p + float(off) for p, off in zip(pos_list, self.offsets)], -1)
        bounds = [torch.full((t,), float(v), device=pos.device, dtype=pos.dtype)
                  for v in self.offsets]
        lo = torch.cat(bounds)
        hi = torch.cat([bd + float(s) for bd, s in zip(bounds, self.sizes)])
        p = pos.reshape(-1, pos.shape[-1])
        out = _gather_lerp(self.cat.reshape(-1, c, ltot), p, lo.expand_as(p), hi.expand_as(p))
        out = out.reshape(b, h, w, c, len(pos_list), t)
        return [out[..., i, :].reshape(b, h, w, c * t) for i in range(len(pos_list))]


def lookup_dtype(dtype: torch.dtype) -> torch.dtype:
    """The pyramids' storage and compute dtype (`geometry.py:112`): bf16 for a
    bf16 model, else at least f32."""
    if dtype == torch.bfloat16:
        return torch.bfloat16
    return torch.promote_types(torch.float32, dtype)


def avg_pool_last(x: torch.Tensor) -> torch.Tensor:
    """2× average pool along the last axis (`geometry.py:123`); an odd last
    element is dropped. The pair's mean is taken in at least f32 and rounded
    once, as `jnp.mean` does for bf16."""
    n = x.shape[-1] // 2
    pairs = x[..., : 2 * n].reshape(*x.shape[:-1], n, 2)
    return pairs.to(head_dtype(x.dtype)).mean(-1).to(x.dtype)


def all_pairs_correlation(fmap1: torch.Tensor, fmap2: torch.Tensor) -> torch.Tensor:
    """[B,C,H,W] × [B,C,H,W2] → [B,H,W,W2]: Σ_c fmap1[c,h,w]·fmap2[c,h,v], one
    matrix product per row (`geometry.py:129`, which takes NHWC)."""
    return torch.matmul(fmap1.permute(0, 2, 3, 1), fmap2.permute(0, 2, 1, 3))


class CombinedGeoEncodingVolume:
    """The pyramids, pooled once; a call samples them at one GRU iteration's
    disparity (`geometry.py:137`).

    match_left, match_right: [B,C,H,W]; geo_volume: [B,G,D,H,W] (NCDHW).
    The geometry pyramid is geo_volume in the lookup layout [B,H,W,G,D],
    the correlation pyramid the all-pairs correlation [B,H,W,1,W2], each
    level the last one's `avg_pool_last`."""

    def __init__(self, match_left: torch.Tensor, match_right: torch.Tensor,
                 geo_volume: torch.Tensor, num_levels: int = 2, radius: int = 4):
        self.num_levels = num_levels
        self.radius = radius
        geo = geo_volume.permute(0, 3, 4, 1, 2).contiguous()
        corr = all_pairs_correlation(match_left, match_right)[:, :, :, None, :]
        geo_pyramid, corr_pyramid = [geo], [corr]
        for _ in range(num_levels - 1):
            geo_pyramid.append(avg_pool_last(geo_pyramid[-1]))
            corr_pyramid.append(avg_pool_last(corr_pyramid[-1]))
        self.geo_lookup = MultiLookup(geo_pyramid)
        self.corr_lookup = MultiLookup(corr_pyramid)

    def lookups(self, geo_pos: Sequence[torch.Tensor],
                corr_pos: Sequence[torch.Tensor]) -> torch.Tensor:
        """The two pyramids sampled at their own per-level positions
        ([B,H,W,T] each, pixel coordinates of each level), as FoundationStereo's
        iteration calls `geo_lookup` and `corr_lookup` (`foundationstereo.py:
        160-170`) → [B,H,W,num_levels·(G+1)·T], per level the geometry taps
        then the correlation taps."""
        geo, corr = self.geo_lookup(geo_pos), self.corr_lookup(corr_pos)
        return torch.cat([f for pair in zip(geo, corr) for f in pair], dim=-1)

    def __call__(self, disp: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        """disp, coords: [B,H,W] → `lookups` at the 2r+1 taps around disp / 2^i
        (geometry) and (coords - disp) / 2^i (correlation) on level i."""
        r = self.radius
        dx = torch.arange(-r, r + 1, dtype=disp.dtype, device=disp.device)
        scales = [2.0 ** i for i in range(self.num_levels)]
        return self.lookups([disp[..., None] / s + dx for s in scales],
                            [(coords - disp)[..., None] / s + dx for s in scales])
