"""Hand-written CUDA kernels: build/load helpers and launch counts.

`launch_counts[name]` is raised by one by a kernel's wrapper right after
it launched that kernel on the card, and nowhere else; a run reads it to
show that its main path went through the kernels. `launch_shapes[name]`
counts the same launches by the shape key the wrapper passes, so a run can
also show at which shapes they ran.

The inference kernels (K1, K2, K3) have no backward. `without_backward`
makes their wrappers' results fail loudly under autograd rather than cut
a gradient without a word.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Dict, Tuple

import torch

launch_counts = {"corr_volume": 0, "fused_mbconv": 0, "rel_attention": 0, "gwc_volume": 0}
launch_shapes: Dict[str, Counter] = {k: Counter() for k in launch_counts}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0
        launch_shapes[k].clear()


def check_launch(name: str, err: int, shape: Tuple) -> None:
    """Raise on a launcher's non-zero cudaError_t, else count the launch
    (in total and under `shape`)."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    launch_counts[name] += 1
    launch_shapes[name][shape] += 1


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


class _NoBackward(torch.autograd.Function):
    """The result of `compute(*inputs)` as the output of an autograd node
    whose backward raises, naming the plain function to train through."""

    @staticmethod
    def forward(ctx, compute, name, plain, *inputs):
        ctx.message = (f"{name} has no backward: a training forward must build this tensor "
                       f"with {plain}, which autograd differentiates")
        return compute(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(ctx.message)


def without_backward(name: str, plain: str, compute: Callable, *inputs: torch.Tensor):
    """`compute(*inputs)`, a kernel wrapper's result (its kernel on the card,
    its plain version on the CPU). With grad mode on and an input that
    requires grad, the result is an output of `_NoBackward`: the forward's
    values are unchanged, so an eval forward outside `torch.no_grad()` still
    works, but a backward through it raises on every device, naming `plain`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _NoBackward.apply(compute, name, plain, *inputs)
    return compute(*inputs)
