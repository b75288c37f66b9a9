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
    Planes with d ≥ W are zero. Rounds as JAX's `jnp.mean(l * r)` does: each
    product in the input dtype, their mean in at least f32, the result once
    to the input dtype.
    """
    return build_gwc_volume(left, right, max_disp, 1)[:, 0]


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
    d ≥ W are zero. Rounds as JAX's `groupwise_correlation` does on bf16
    features: each product in the input dtype (so a bf16 product is rounded
    to bf16), their mean over a group's C/G channels accumulated in f32
    (torch's `mean` of bf16 does), the result once to the input dtype.
    """
    b, _, h, w = left.shape
    out = left.new_zeros((b, num_groups, max_disp, h, w))
    for d in range(min(max_disp, w)):
        out[:, :, d, :, d:] = groupwise_correlation(left[..., d:], right[..., :w - d], num_groups)
    return out


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


def build_sub_volume(left: torch.Tensor, right: torch.Tensor, max_disp: int) -> torch.Tensor:
    """L1-distance volume, [B,C,H,W] ×2 → [B,D,H,W]: Σ_c |L − R shifted by d|.

    JAX counterpart: `ops/cost_volume.py:build_sub_volume` ([B,H,W,D], the
    transpose (0,2,3,1) of this one). Unlike the other builders, where the
    right view is out of frame (w < d) the cost is not zero but the L1 norm
    of the left features alone, as the reference computes it.
    """
    b, _, h, w = left.shape
    l1_left = left.abs().sum(dim=1)  # [B,H,W]
    out = l1_left[:, None].repeat(1, max_disp, 1, 1)
    for d in range(min(max_disp, w)):
        out[:, d, :, d:] = (left[..., d:] - right[..., :w - d]).abs().sum(dim=1)
    return out
