"""Cost-volume builders, NCHW / NCDHW (counterpart of `openstereo_tpu/ops/cost_volume.py`).

Stereo convention as in the JAX package: for disparity d the left pixel
(h, w) matches the right pixel (h, w - d); out-of-frame entries are 0.
"""

from __future__ import annotations

import torch


def correlation_volume(left: torch.Tensor, right: torch.Tensor, max_disp: int) -> torch.Tensor:
    """Mean-product correlation volume, [B,C,H,W] ×2 → [B,D,H,W], D = max_disp.

    JAX counterpart: `ops/cost_volume.py:correlation_volume`, which maps
    [B,H,W,C] → [B,H,W,D]; the port's volume is its transpose (0,3,1,2).
    Planes with d ≥ W are zero. Accumulates in at least f32 and returns the
    input dtype.
    """
    b, c, h, w = left.shape
    acc = torch.promote_types(torch.float32, left.dtype)
    l, r = left.to(acc), right.to(acc)
    out = l.new_zeros((b, max_disp, h, w))
    for d in range(min(max_disp, w)):
        if d == 0:
            out[:, 0] = (l * r).mean(dim=1)
        else:
            out[:, d, :, d:] = (l[..., d:] * r[..., :-d]).mean(dim=1)
    return out.to(left.dtype)


def groupwise_correlation(fea1: torch.Tensor, fea2: torch.Tensor, num_groups: int) -> torch.Tensor:
    """[B,C,...] × [B,C,...] → [B,G,...]: the mean product over each group of
    C/G consecutive channels, in the inputs' dtype (counterpart of
    `openstereo_tpu/ops/cost_volume.py:groupwise_correlation`, channels last)."""
    b, c = fea1.shape[:2]
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    prod = (fea1 * fea2).reshape(b, num_groups, c // num_groups, *fea1.shape[2:])
    return prod.mean(dim=2)


def build_gwc_volume(left: torch.Tensor, right: torch.Tensor, max_disp: int,
                     num_groups: int) -> torch.Tensor:
    """Group-wise correlation volume, [B,C,H,W] ×2 → [B,G,D,H,W], D = max_disp.

    JAX counterpart: `ops/cost_volume.py:build_gwc_volume`, which returns
    [B,D,H,W,G]; the port's volume is its transpose (0,4,1,2,3). Planes with
    d ≥ W are zero. Accumulates in at least f32 and returns the input dtype.
    """
    b, c, h, w = left.shape
    acc = torch.promote_types(torch.float32, left.dtype)
    l, r = left.to(acc), right.to(acc)
    out = l.new_zeros((b, num_groups, max_disp, h, w))
    for d in range(min(max_disp, w)):
        out[:, :, d, :, d:] = groupwise_correlation(l[..., d:], r[..., :w - d], num_groups)
    return out.to(left.dtype)


def build_concat_volume(left: torch.Tensor, right: torch.Tensor, max_disp: int) -> torch.Tensor:
    """Concatenation volume, [B,C,H,W] ×2 → [B,2C,D,H,W]: left features and
    the d-shifted right features, both 0 where the right view is out of frame.

    JAX counterpart: `ops/cost_volume.py:build_concat_volume` ([B,D,H,W,2C],
    the transpose (0,4,1,2,3) of this one). Planes with d ≥ W are zero here;
    the JAX version has no such branch and fails for d > W.
    """
    b, c, h, w = left.shape
    out = left.new_zeros((b, 2 * c, max_disp, h, w))
    for d in range(min(max_disp, w)):
        out[:, :c, d, :, d:] = left[..., d:]
        out[:, c:, d, :, d:] = right[..., :w - d]
    return out
