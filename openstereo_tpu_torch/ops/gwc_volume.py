"""Group-wise correlation volume through the hand-written CUDA kernel (`csrc/cost_volume.cu`).

Port of the TPU kernel `openstereo_tpu/ops/pallas/corr_volume.py:
build_gwc_volume_pallas` (the `correlation_volume_pallas` call with
num_groups > 1). The plain version is `ops.cost_volume.build_gwc_volume`,
which the wrapper runs for a tensor on the CPU; a CUDA tensor launches the
kernel or raises. The result has no backward (`kernels.without_backward`):
training builds its volume with the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import kernels
from .cost_volume import build_gwc_volume as gwc_volume_plain
from .kernels import build

__all__ = ["gwc_volume", "gwc_volume_plain"]


def gwc_volume(left: torch.Tensor, right: torch.Tensor, max_disp: int,
               num_groups: int, divisor: Optional[int] = None) -> torch.Tensor:
    """[B,C,H,W] ×2 (f32 or bf16) → [B,G,D,H,W] in the input dtype, D = max_disp,
    G = num_groups dividing C; any C/G. Each group's sum of products is
    divided by `divisor`: C/G (None, the mean) or 1 (the sum, which
    FoundationStereo's cosine volume takes over normalised features,
    `ops.cost_volume.build_cosine_gwc_volume`).

    JAX counterpart: `build_gwc_volume_pallas(l, r, D, G)` on the NHWC
    transposes, whose [B,D,H,W,G] result is this one's transpose (0,2,3,4,1).
    A launch is counted under (B, C, H, W, D, G), with the divisor appended
    where it is not C/G.
    """
    if left.shape != right.shape or left.dim() != 4:
        raise ValueError(f"left/right must be equal [B,C,H,W], got {left.shape}, {right.shape}")
    if left.dtype != right.dtype or left.dtype not in kernels.DTYPE_CODES:
        raise TypeError(f"gwc_volume takes float32 or bfloat16, got {left.dtype}, {right.dtype}")
    if left.device != right.device:
        raise ValueError("left and right lie on different devices")
    if max_disp <= 0 or num_groups <= 0 or left.shape[1] % num_groups:
        raise ValueError(f"need max_disp > 0 and num_groups dividing C={left.shape[1]}, "
                         f"got {max_disp}, {num_groups}")
    cg = left.shape[1] // num_groups
    divisor = cg if divisor is None else divisor
    if divisor not in (cg, 1):
        raise ValueError(f"divisor {divisor}: K3 takes C/G = {cg} or 1")
    return kernels.without_backward(
        "gwc_volume", "ops.cost_volume.build_gwc_volume",
        lambda lt, rt: _gwc_volume(lt, rt, max_disp, num_groups, divisor), left, right)


def _gwc_volume(left: torch.Tensor, right: torch.Tensor, max_disp: int,
                num_groups: int, divisor: int) -> torch.Tensor:
    if left.device.type == "cpu":
        return gwc_volume_plain(left, right, max_disp, num_groups, divisor)
    if left.device.type != "cuda":
        raise RuntimeError(f"gwc_volume has no kernel for device {left.device}")
    if not (left.is_contiguous() and right.is_contiguous()):
        raise ValueError("gwc_volume needs contiguous NCHW inputs")
    b, c, h, w = left.shape
    out = torch.empty((b, num_groups, max_disp, h, w), dtype=left.dtype, device=left.device)
    lib = build.load("cost_volume")
    err = lib.gwc_volume_launch(left.data_ptr(), right.data_ptr(), out.data_ptr(),
                                b, c, h, w, max_disp, num_groups, divisor,
                                kernels.DTYPE_CODES[left.dtype],
                                kernels.stream_handle(left.device))
    shape = (b, c, h, w, max_disp, num_groups) + ((divisor,) if divisor != c // num_groups else ())
    kernels.check_launch("gwc_volume", err, shape)
    return out
