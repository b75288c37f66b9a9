"""Cost-volume builders, NCHW / NCDHW (counterpart of `openstereo_tpu/ops/cost_volume.py`).

Stereo convention as in the JAX package: for disparity d the left pixel
(h, w) matches the right pixel (h, w - d); out-of-frame entries are 0.
"""

from __future__ import annotations

from typing import Optional

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


def groupwise_correlation(fea1: torch.Tensor, fea2: torch.Tensor, num_groups: int,
                          divisor: Optional[int] = None) -> torch.Tensor:
    """[B,C,...] × [B,C,...] → [B,G,...]: the mean product over each group of
    C/G consecutive channels, in the inputs' dtype (counterpart of
    `openstereo_tpu/ops/cost_volume.py:groupwise_correlation`, channels last);
    with `divisor` 1 their sum (accumulated in f32 for bf16, as the mean)."""
    b, c = fea1.shape[:2]
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    prod = (fea1 * fea2).reshape(b, num_groups, c // num_groups, *fea1.shape[2:])
    if divisor is None or divisor == c // num_groups:
        return prod.mean(dim=2)
    if divisor == 1:
        return prod.sum(dim=2)
    raise ValueError(f"divisor {divisor}: the volumes take C/G = {c // num_groups} or 1")


def build_gwc_volume(left: torch.Tensor, right: torch.Tensor, max_disp: int,
                     num_groups: int, divisor: Optional[int] = None) -> torch.Tensor:
    """Group-wise correlation volume, [B,C,H,W] ×2 → [B,G,D,H,W], D = max_disp.

    JAX counterpart: `ops/cost_volume.py:build_gwc_volume`, which returns
    [B,D,H,W,G]; the port's volume is its transpose (0,4,1,2,3). Planes with
    d ≥ W are zero. Rounds as JAX's `groupwise_correlation` does on bf16
    features: each product in the input dtype (so a bf16 product is rounded
    to bf16), their mean over a group's C/G channels accumulated in f32
    (torch's `mean` of bf16 does), the result once to the input dtype.
    `divisor` 1 takes the groups' sums instead of their means
    (`build_cosine_gwc_volume`); None or C/G is the mean.
    """
    b, _, h, w = left.shape
    out = left.new_zeros((b, num_groups, max_disp, h, w))
    for d in range(min(max_disp, w)):
        out[:, :, d, :, d:] = groupwise_correlation(left[..., d:], right[..., :w - d], num_groups,
                                                    divisor)
    return out


def l2_normalize(x: torch.Tensor, dim: int, eps: float = 1e-12) -> torch.Tensor:
    """x / sqrt(Σ x² + eps) along `dim`, in x's dtype (FoundationStereo's
    `_l2_normalize`, `openstereo_tpu/models/foundationstereo/foundationstereo.py:56`;
    a bf16 sum of squares accumulates in f32 and rounds once, as `jnp.sum`)."""
    return x / torch.sqrt((x * x).sum(dim=dim, keepdim=True) + eps)


def normalize_groups(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    """[B,C,H,W] with each group of C/G consecutive channels L2-normalised."""
    b, c = x.shape[:2]
    return l2_normalize(x.reshape(b, num_groups, c // num_groups, *x.shape[2:]), 2).reshape(
        x.shape)


def build_cosine_gwc_volume(left: torch.Tensor, right: torch.Tensor, max_disp: int,
                            num_groups: int) -> torch.Tensor:
    """FoundationStereo's cosine group-wise volume, [B,C,H,W] ×2 →
    [B,G,D,H,W]: per group the sum of the products of the L2-normalised
    features, 0 where w < d (counterpart of `build_cosine_gwc_volume`,
    `foundationstereo.py:60-74`, whose [B,D,H,W,G] is this one's transpose
    (0,4,1,2,3)): `build_gwc_volume` with divisor 1 on `normalize_groups`
    of both views. The plain version of K3 with divisor 1."""
    return build_gwc_volume(normalize_groups(left, num_groups),
                            normalize_groups(right, num_groups), max_disp, num_groups, 1)


def build_fs_concat_volume(left: torch.Tensor, right: torch.Tensor,
                           max_disp: int) -> torch.Tensor:
    """FoundationStereo's concatenation volume, [B,C,H,W] ×2 → [B,2C,D,H,W]:
    the left features at every plane, not zeroed, and the d-shifted right
    features, 0 where w < d (counterpart of `build_fs_concat_volume`,
    `foundationstereo.py:77-85`)."""
    b, c, h, w = left.shape
    out = left.new_zeros((b, 2 * c, max_disp, h, w))
    out[:, :c] = left[:, :, None]
    for d in range(min(max_disp, w)):
        out[:, c:, d, :, d:] = right[..., :w - d]
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
