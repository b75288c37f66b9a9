"""Soft-argmax disparity regressions (counterparts of
`openstereo_tpu/ops/disp_regression.py:8-24` and of CoEx's top-k head,
`openstereo_tpu/models/coex/coex.py:174-178`)."""

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


def topk_disparity_regression(cost: torch.Tensor, k: int) -> torch.Tensor:
    """CoEx's top-k soft-argmax, [B,D,H,W] → [B,H,W]: the k largest costs
    over D (ties taken lower index first, as `jax.lax.top_k` takes them), a
    softmax over those k values, and the index-weighted sum, all in cost's
    dtype.

    `torch.topk` makes no promise about ties, so the k come from a stable
    descending sort, which keeps equal values in index order.
    """
    vals, idx = torch.sort(cost, dim=1, descending=True, stable=True)
    prob = torch.softmax(vals[:, :k], dim=1)
    return (prob * idx[:, :k].to(cost.dtype)).sum(dim=1)
