"""Fused inference MBConv through the hand-written CUDA kernels
(`csrc/fused_mbconv.cu`: tensor cores for bf16, CUDA cores for f32).

Port of the TPU kernel `openstereo_tpu/ops/pallas/fused_mbconv.py:
fused_mbconv` (with its `fold_bn` and `mbconv_reference`): stride-1
pw-expand → dw3×3 → pw-linear with BatchNorms folded, relu6 after the first
two, and the residual when Cin == Cout.

Layouts: x and the result are NCHW; the folded weights keep the JAX
kernel's layouts, w1 [Cin,Ch], dw [9,Ch] (tap 3·di+dj), w2 [Ch,Cout], so a
test hands the same weight arrays to both. Biases are f32.

The bf16 kernel owns 8×16 output tiles and walks the hidden channels in
chunks of 32. Where the tiles would not fill two waves of the card's SMs,
the launcher spreads a tile's chunks over S blocks (its choice,
`fused_mbconv_splits` in the source, sizes the workspace here), which
write f32 partial projections that a second kernel sums in a fixed order:
one call then issues two device kernels, and counts one launch.

The result has no backward (`kernels.without_backward`): the BatchNorms
are folded, so training runs the eager conv/BatchNorm chain instead.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import kernels
from .kernels import build

__all__ = ["fold_bn", "fold_mbconv", "mbconv_plain", "fused_mbconv"]

MAX_CIN = 256   # the x halo tile of the widest input stays in shared memory
MAX_COUT = 192  # the projection's f32 accumulators stay in registers


def fold_bn(kernel: torch.Tensor, scale, bias, mean, var, eps: float = 1e-5):
    """Fold an eval BatchNorm into the conv before it, in f32.

    kernel: torch layout [Cout, ...]; returns (kernel·γ/σ, β − γ·µ/σ). The
    JAX counterpart `fold_bn` takes the kernel with Cout last.
    """
    g = scale.float() / torch.sqrt(var.float() + eps)
    shape = (-1,) + (1,) * (kernel.dim() - 1)
    return kernel.float() * g.reshape(shape), bias.float() - mean.float() * g


def fold_mbconv(pw: torch.Tensor, bn1, dw: torch.Tensor, bn2, pwl: torch.Tensor, bn3,
                dtype: torch.dtype) -> Tuple[torch.Tensor, ...]:
    """Conv weights (torch layouts) + their eval BatchNorm modules → the
    kernel's (w1, b1, dw, b2, w2, b3): weights cast to `dtype`, biases f32."""
    folded = []
    with torch.no_grad():
        for w, bn in ((pw, bn1), (dw, bn2), (pwl, bn3)):
            wf, bf = fold_bn(w, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
            folded += [wf.reshape(wf.shape[0], -1).t().contiguous().to(dtype), bf.contiguous()]
    return tuple(folded)


def mbconv_plain(x, w1, b1, dw, b2, w2, b3, residual: bool = True) -> torch.Tensor:
    """Plain PyTorch version, computed in at least f32 with the hidden h and
    the depthwise d rounded to x's dtype, returned in x's dtype.

    JAX counterpart: `mbconv_reference` on the NHWC transpose of x.
    """
    acc = torch.promote_types(torch.float32, x.dtype)
    xf = x.to(acc)
    ch = w1.shape[1]
    h = torch.einsum("bchw,cd->bdhw", xf, w1.to(acc)) + b1.to(acc)[:, None, None]
    # h and d are rounded to x's dtype before the next product, where the TPU
    # kernel keeps them in x's dtype; the dw conv's zero padding is h's
    # out-of-frame zeroing
    h = h.clamp(0.0, 6.0).to(x.dtype).to(acc)
    d = F.conv2d(h, dw.to(acc).t().reshape(ch, 1, 3, 3), b2.to(acc), padding=1, groups=ch)
    d = d.clamp(0.0, 6.0).to(x.dtype).to(acc)
    y = torch.einsum("bchw,cd->bdhw", d, w2.to(acc)) + b3.to(acc)[:, None, None]
    if residual:
        y = y + xf
    return y.to(x.dtype)


def _check(x, w1, b1, dw, b2, w2, b3, residual):
    if x.dim() != 4:
        raise ValueError(f"x must be [B,Cin,H,W], got {tuple(x.shape)}")
    if x.dtype not in kernels.DTYPE_CODES:
        raise TypeError(f"fused_mbconv takes float32 or bfloat16, got {x.dtype}")
    cin, ch, cout = x.shape[1], w1.shape[-1], w2.shape[-1]
    shapes = {"w1": (w1, (cin, ch)), "dw": (dw, (9, ch)), "w2": (w2, (ch, cout)),
              "b1": (b1, (ch,)), "b2": (b2, (ch,)), "b3": (b3, (cout,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} lies on {t.device}, x on {x.device}")
        want = x.dtype if name[0] in "wd" else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
    if residual and cin != cout:
        raise ValueError(f"residual needs Cin == Cout, got {cin} and {cout}")
    if cin > MAX_CIN or cout > MAX_COUT:
        raise ValueError(f"fused_mbconv takes Cin <= {MAX_CIN} and Cout <= {MAX_COUT}, "
                         f"got {cin} and {cout}")


def fused_mbconv(x, w1, b1, dw, b2, w2, b3, residual: bool = True) -> torch.Tensor:
    """x [B,Cin,H,W] → [B,Cout,H,W] (+x if residual), stride 1, in x's dtype.

    JAX counterpart: `fused_mbconv(x_nhwc, w1, b1, dw, b2, w2, b3)` with the
    same weight arrays; its result is this one's transpose (0,2,3,1).
    """
    _check(x, w1, b1, dw, b2, w2, b3, residual)
    return kernels.without_backward(
        "fused_mbconv", "the eager conv/BatchNorm chain (or ops.fused_mbconv.mbconv_plain)",
        lambda *t: _fused_mbconv(*t, residual=residual), x, w1, b1, dw, b2, w2, b3)


def _fused_mbconv(x, w1, b1, dw, b2, w2, b3, residual: bool) -> torch.Tensor:
    if x.device.type == "cpu":
        return mbconv_plain(x, w1, b1, dw, b2, w2, b3, residual)
    if x.device.type != "cuda":
        raise RuntimeError(f"fused_mbconv has no kernel for device {x.device}")
    tensors = (x, w1, b1, dw, b2, w2, b3)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_mbconv needs contiguous inputs")
    b, cin, h, w = x.shape
    ch, cout = w1.shape[1], w2.shape[1]
    lib = build.load("fused_mbconv")
    dtype = kernels.DTYPE_CODES[x.dtype]
    splits = lib.fused_mbconv_splits(b, h, w, ch, dtype)
    if splits < 1:
        raise RuntimeError("fused_mbconv could not read the card's SM count")
    out = torch.empty((b, cout, h, w), dtype=x.dtype, device=x.device)
    ws = (torch.empty((splits, b, cout, h, w), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    err = lib.fused_mbconv_launch(*(t.data_ptr() for t in tensors), out.data_ptr(),
                                  ws.data_ptr() if ws is not None else None,
                                  b, cin, ch, cout, h, w, int(residual), splits,
                                  dtype, kernels.stream_handle(x.device))
    kernels.check_launch("fused_mbconv", err, (b, h, w, cin, ch, cout, bool(residual)))
    return out
