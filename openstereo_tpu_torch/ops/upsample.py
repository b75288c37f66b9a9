"""Upsampling and linear resizes (counterpart of `openstereo_tpu/ops/upsample.py`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def unfold3x3(x: torch.Tensor) -> torch.Tensor:
    """[B,H,W] → [B,9,H,W]: zero-padded 3×3 neighbourhood taps.

    Tap k is (dy=k//3-1, dx=k%3-1), the order of `F.unfold`. The JAX
    counterpart returns [B,H,W,9]; the port's taps are its transpose (0,3,1,2).
    """
    b, h, w = x.shape
    return F.unfold(x[:, None], kernel_size=3, padding=1).reshape(b, 9, h, w)


def upsample_nearest(x: torch.Tensor, scale: int, dims=(-2, -1)) -> torch.Tensor:
    """Exact integer nearest-neighbour upsample by repetition."""
    for d in dims:
        x = torch.repeat_interleave(x, scale, dim=d)
    return x


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """Nearest resize of the len(size) trailing axes, up or down, with
    half-pixel centres: output i reads input ⌊(i + ½)·n_in / n_out⌋, with no
    antialiasing (counterpart of `jax.image.resize(..., method="nearest")`,
    as `models/igev/blocks.py:91` and `models/coex/coex.py:145-147` call it;
    torch's "nearest-exact" mode, in exact integer arithmetic)."""
    size = tuple(size)
    for axis, n in zip(range(x.dim() - len(size), x.dim()), size):
        m = x.shape[axis]
        if n != m:
            src = (2 * torch.arange(n, device=x.device) + 1) * m // (2 * n)
            x = x.index_select(axis, src)
    return x


def context_upsample(disp_low: torch.Tensor, up_weights: torch.Tensor,
                     scale_factor: int = 4) -> torch.Tensor:
    """disp_low [B,h,w], up_weights [B,9,s·h,s·w] → [B,s·h,s·w].

    JAX counterpart takes up_weights as [B,s·h,s·w,9] (transpose (0,2,3,1)
    of the port's).
    """
    taps = upsample_nearest(unfold3x3(disp_low), scale_factor)  # [B,9,sh,sw]
    return (taps * up_weights).sum(dim=1)


def _interpolate(x: torch.Tensor, size, mode: str, align_corners: bool) -> torch.Tensor:
    """F.interpolate in at least f32, the result rounded once to x's dtype:
    PyTorch's CPU bilinear resize of a bf16 tensor rounds its weights to
    bf16 (up to ~30 bf16 units off the exact resize where values are small),
    and one rounding of the f32 resize is what the port promises (ROADMAP
    §3, 3b)."""
    acc = torch.promote_types(torch.float32, x.dtype)
    out = F.interpolate(x.to(acc), size=size, mode=mode, align_corners=align_corners)
    return out.to(x.dtype)


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """[B,C,h,w] → [B,C,*size], bilinear with half-pixel centres
    (counterpart of `openstereo_tpu/ops/upsample.py:48-53`).

    `jax.image.resize` equals `F.interpolate(align_corners=False)` only when
    it does not shrink an axis (it antialiases when it downsamples), so a
    downsampling call raises rather than quietly differ.
    """
    size = tuple(size)
    if size[0] < x.shape[-2] or size[1] < x.shape[-1]:
        raise ValueError(f"resize_bilinear only upsamples: {tuple(x.shape[-2:])} → {size}")
    if size == tuple(x.shape[-2:]):
        return x
    return _interpolate(x, size, "bilinear", False)


def resize_trilinear(x: torch.Tensor, size) -> torch.Tensor:
    """[B,C,d,h,w] → [B,C,*size], trilinear with half-pixel centres
    (counterpart of `resize_linear_torch` at `openstereo_tpu/ops/upsample.py:98`
    and of `jax.image.resize(..., "trilinear")`, which agree when no axis
    shrinks). Like `resize_bilinear`, it refuses a downsample, where
    `jax.image.resize` would antialias."""
    size = tuple(size)
    if any(n < m for n, m in zip(size, x.shape[-3:])):
        raise ValueError(f"resize_trilinear only upsamples: {tuple(x.shape[-3:])} → {size}")
    if size == tuple(x.shape[-3:]):
        return x
    return _interpolate(x, size, "trilinear", False)


def resize_linear(x: torch.Tensor, size) -> torch.Tensor:
    """[B,C,*spatial] → [B,C,*size], bi- or trilinear with half-pixel centres
    over the 2 or 3 trailing axes and no antialiasing, also where an axis
    shrinks (counterpart of `openstereo_tpu/ops/upsample.py:98`,
    `resize_linear_torch`, which CasNet uses to shrink its sample grids).
    Unlike `resize_bilinear`, which stands for `jax.image.resize`, it takes a
    downsample: a fixed 2-tap kernel at any scale, border taps clamped."""
    size = tuple(size)
    mode = {2: "bilinear", 3: "trilinear"}[len(size)]
    if x.dim() != len(size) + 2:
        raise ValueError(f"{mode} resize of a {x.dim()}-d tensor to {size}")
    if size == tuple(x.shape[2:]):
        return x
    return _interpolate(x, size, mode, False)


def resize_linear_align_corners(x: torch.Tensor, size) -> torch.Tensor:
    """[B,C,*spatial] → [B,C,*size], bi- or trilinear with align_corners=True
    over the 2 or 3 trailing axes (counterpart of
    `openstereo_tpu/ops/upsample.py:111`, `resize_linear_align_corners`). An
    axis of length 1 is broadcast, as the JAX interpolation matrix does."""
    size = tuple(size)
    mode = {2: "bilinear", 3: "trilinear"}[len(size)]
    if x.dim() != len(size) + 2:
        raise ValueError(f"{mode} resize of a {x.dim()}-d tensor to {size}")
    if size == tuple(x.shape[2:]):
        return x
    return _interpolate(x, size, mode, True)


def resize_bicubic_torch(x: torch.Tensor, size) -> torch.Tensor:
    """[B,C,h,w] → [B,C,*size], PyTorch's bicubic with align_corners=False (the
    cubic kernel with A = -0.75, half-pixel centres, edge taps clamped, no
    antialiasing), up or down (counterpart of `openstereo_tpu/ops/upsample.py:156`,
    `resize_bicubic_torch`, which applies `_interp_matrix_cubic_hp` along each
    axis; FoundationStereo's ViT input). Computed in at least f32 and rounded
    once to x's dtype: the JAX matrices take x's dtype, so on a bf16 x JAX
    rounds the weights and each axis's result (ROADMAP §3, 3b), where the
    port rounds once; on the main path x is f32 on both sides."""
    size = tuple(size)
    if size == tuple(x.shape[-2:]):
        return x
    return _interpolate(x, size, "bicubic", False)
