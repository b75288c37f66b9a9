"""Correlation volume through the hand-written CUDA kernel (`csrc/cost_volume.cu`).

Port of the TPU kernel `openstereo_tpu/ops/pallas/corr_volume.py:
correlation_volume_pallas` (num_groups=1). The plain version is
`ops.cost_volume.correlation_volume`, which the wrapper runs for a tensor
on the CPU; a CUDA tensor launches the kernel or raises. The result has
no backward (`kernels.without_backward`): training builds its volume with
the plain version.
"""

from __future__ import annotations

import torch

from . import kernels
from .cost_volume import correlation_volume as corr_volume_plain
from .kernels import build

__all__ = ["corr_volume", "corr_volume_plain"]


def corr_volume(left: torch.Tensor, right: torch.Tensor, max_disp: int) -> torch.Tensor:
    """[B,C,H,W] ×2 (f32 or bf16) → [B,D,H,W] in the input dtype, D = max_disp.

    JAX counterpart: `correlation_volume_pallas(l, r, D)` on the NHWC
    transposes, whose [B,H,W,D] result is this one's transpose (0,2,3,1).
    """
    if left.shape != right.shape or left.dim() != 4:
        raise ValueError(f"left/right must be equal [B,C,H,W], got {left.shape}, {right.shape}")
    if left.dtype != right.dtype or left.dtype not in kernels.DTYPE_CODES:
        raise TypeError(f"corr_volume takes float32 or bfloat16, got {left.dtype}, {right.dtype}")
    if left.device != right.device:
        raise ValueError("left and right lie on different devices")
    if max_disp <= 0:
        raise ValueError(f"max_disp must be positive, got {max_disp}")
    return kernels.without_backward("corr_volume", "ops.cost_volume.correlation_volume",
                                    lambda lt, rt: _corr_volume(lt, rt, max_disp), left, right)


def _corr_volume(left: torch.Tensor, right: torch.Tensor, max_disp: int) -> torch.Tensor:
    if left.device.type == "cpu":
        return corr_volume_plain(left, right, max_disp)
    if left.device.type != "cuda":
        raise RuntimeError(f"corr_volume has no kernel for device {left.device}")
    if not (left.is_contiguous() and right.is_contiguous()):
        raise ValueError("corr_volume needs contiguous NCHW inputs")
    b, c, h, w = left.shape
    out = torch.empty((b, max_disp, h, w), dtype=left.dtype, device=left.device)
    lib = build.load("cost_volume")
    err = lib.corr_volume_launch(left.data_ptr(), right.data_ptr(), out.data_ptr(),
                                 b, c, h, w, max_disp, kernels.DTYPE_CODES[left.dtype],
                                 kernels.stream_handle(left.device))
    kernels.check_launch("corr_volume", err, (b, c, h, w, max_disp))
    return out
