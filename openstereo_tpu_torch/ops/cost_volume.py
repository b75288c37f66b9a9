"""Cost-volume builders, NCHW (counterpart of `openstereo_tpu/ops/cost_volume.py`).

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
