"""Soft-argmax disparity regression (counterpart of `openstereo_tpu/ops/disp_regression.py:8-24`)."""

from __future__ import annotations

import torch


def disparity_regression(prob: torch.Tensor, max_disp: int, dim: int = 1,
                         interval: int = 1) -> torch.Tensor:
    """Expected disparity under a softmaxed volume; `dim` is reduced.

    The port's default layout is [B,D,H,W] (dim=1); the JAX default is
    [B,H,W,D] (axis=-1). Both return [B,H,W].
    """
    n = max_disp // interval
    assert prob.shape[dim] == n, (prob.shape, dim, max_disp, interval)
    shape = [1] * prob.ndim
    shape[dim] = n
    values = torch.arange(0, max_disp, interval, dtype=prob.dtype,
                          device=prob.device).reshape(shape)
    return (prob * values).sum(dim=dim)
