"""STTR relative-position epipolar attention through the hand-written CUDA kernels
(`csrc/rel_attention.cu`: tensor cores for bf16, CUDA cores for f32).

Port of the TPU kernel `openstereo_tpu/ops/pallas/rel_attention.py:
rel_attention` and of its trainable form `rel_attention_trainable` (`:243`),
an autograd Function whose forward is `rel_attention` and whose backward is
`_rel_attn_bwd` (`:181`) in PyTorch. The plain version `rel_attention_plain`
is the counterpart of `rel_attention_reference` in the same file; the
wrapper runs it for a tensor on the CPU, and a CUDA tensor launches the
kernel or raises.

Contract, per line b, head h (channels h·hd … h·hd+hd-1), query i, key j:

    s[i,j] = q_i·k_j + q_i·ke[W-1-i+j] + k_j·qe[W-1-i+j]

with q and qe pre-scaled by hd^-1/2 and ke, qe the unpadded [2W-1, E]
tables; `masked` sets s[i,j] = -1e30 (finite, as the TPU kernel) for j > i;
softmax over j; out_i = Σ_j p_ij v_j; raw[i,j] = Σ_h s[i,j] in f32. Layout
is the JAX package's [B, W, E]. Inputs are f32 or bf16 (on the CPU also
f64, for the parity tests), summed in at least f32, with
p rounded to v's dtype before p·v as the TPU kernel rounds it; out is in v's
dtype, raw f32 (or None without `need_raw`). The f32 kernel's [32, W]
score tile bounds its W (`smem_bytes`, >= 416 at every hd); the bf16 kernels
stream their key tiles, and only the raw sum's [64, W] f32 tile bounds W
there: the launcher refuses a plan that exceeds shared memory.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import kernels
from .kernels import build

__all__ = ["rel_attention", "rel_attention_plain", "rel_attention_trainable",
           "rel_attention_backward", "rel_index", "MASK_VALUE"]

MASK_VALUE = -1e30
HEAD_DIMS = (8, 16, 32, 64)
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
# the f32 CUDA-core kernel's tile constants (csrc/rel_attention.cu, namespace
# simt): query rows and keys per step; its score tile (and the raw
# accumulator) of TQ rows lives in shared memory
TQ, JC = 32, 64
CUDA_ERROR_INVALID_VALUE = 1  # what the launcher returns for a shape it does not take


def rel_index(w: int, device=None) -> torch.Tensor:
    """[W, W] index into the 2W-1 tables: entry (i, j) is W-1-i+j
    (`openstereo_tpu/models/sttr/transformer.py:47-53`)."""
    i = torch.arange(w, device=device)[:, None]
    j = torch.arange(w, device=device)[None, :]
    return (w - 1) - i + j


def rel_attention_plain(q, k, v, ke, qe, nheads: int, masked: bool = False,
                        need_raw: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version, computed in at least f32 (same contract), with
    the softmax rounded to v's dtype before p·v as the TPU kernel does.

    JAX counterpart: `rel_attention_reference`, which materialises the
    [W, W, E] relative tables the same way.
    """
    acc = torch.promote_types(torch.float32, v.dtype)
    b, w, e = q.shape
    hd = e // nheads
    idx = rel_index(w, q.device)
    k_r = ke.to(acc)[idx].reshape(w, w, nheads, hd)
    q_r = qe.to(acc)[idx].reshape(w, w, nheads, hd)
    qh, kh, vh = (t.to(acc).reshape(b, w, nheads, hd) for t in (q, k, v))
    attn = torch.einsum("bwhc,bvhc->bhwv", qh, kh)
    attn = attn + torch.einsum("bwhc,wvhc->bhwv", qh, k_r)
    attn = attn + torch.einsum("bvhc,wvhc->bhwv", kh, q_r)
    if masked:
        attn = attn.masked_fill(torch.triu(torch.ones(w, w, dtype=torch.bool,
                                                      device=q.device), 1), MASK_VALUE)
    raw = attn.sum(dim=1) if need_raw else None  # f32 (f64 for f64 inputs)
    # p is rounded to v's dtype before p·v, where the TPU kernel rounds it
    p = torch.softmax(attn, dim=-1).to(v.dtype).to(acc)
    out = torch.einsum("bhwv,bvhc->bwhc", p, vh).reshape(b, w, e)
    return out.to(v.dtype), raw


def smem_bytes(w: int, hd: int, need_raw: bool) -> int:
    """Dynamic shared memory of one block of the f32 kernel (mirrors
    `simt::smem_floats` in the source)."""
    hp, rt, sw = hd + 1, TQ + JC - 1, w | 1
    return 4 * ((TQ + JC + 2 * rt) * hp + TQ * sw * (2 if need_raw else 1))


def _check(q, k, v, ke, qe, nheads):
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must be equal [B,W,E], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, w, e = q.shape
    if ke.shape != (2 * w - 1, e) or qe.shape != (2 * w - 1, e):
        raise ValueError(f"ke, qe must be [2W-1, E] = {(2 * w - 1, e)}, "
                         f"got {tuple(ke.shape)}, {tuple(qe.shape)}")
    if e % nheads:
        raise ValueError(f"E={e} is not divisible by nheads={nheads}")
    tensors = (q, k, v, ke, qe)
    # the kernel takes f32 and bf16; the plain version on the CPU also f64
    dtypes = (*kernels.DTYPE_CODES, *((torch.float64,) if q.device.type == "cpu" else ()))
    if any(t.dtype != q.dtype for t in tensors) or q.dtype not in dtypes:
        raise TypeError("rel_attention takes q, k, v, ke, qe of one dtype, float32 or "
                        f"bfloat16 (float64 on the CPU); got {[t.dtype for t in tensors]}")
    if any(t.device != q.device for t in tensors):
        raise ValueError("rel_attention inputs lie on different devices")


def rel_attention(q, k, v, ke, qe, nheads: int, masked: bool = False,
                  need_raw: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """q, k, v [B,W,E], ke, qe [2W-1,E] → (out [B,W,E] in v's dtype, raw
    [B,W,W] f32 or None). q and qe come pre-scaled by hd^-1/2.

    JAX counterpart: `rel_attention(q, k, v, ke, qe, nheads, masked,
    need_raw)` with the same arrays.
    """
    _check(q, k, v, ke, qe, nheads)
    if q.device.type == "cpu":
        return rel_attention_plain(q, k, v, ke, qe, nheads, masked, need_raw)
    if q.device.type != "cuda":
        raise RuntimeError(f"rel_attention has no kernel for device {q.device}")
    b, w, e = q.shape
    hd = e // nheads
    if hd not in HEAD_DIMS:
        raise ValueError(f"rel_attention's kernel takes head widths {HEAD_DIMS}, got {hd}")
    refused = ValueError(f"rel_attention's kernel does not take W={w}, hd={hd}, B={b}, "
                         f"need_raw={need_raw}, {q.dtype} (B > 65535, or W's tiles exceed "
                         f"{SMEM_LIMIT} bytes of shared memory)")
    if b > 65535 or (q.dtype == torch.float32 and smem_bytes(w, hd, need_raw) > SMEM_LIMIT):
        raise refused
    if not all(t.is_contiguous() for t in (q, k, v, ke, qe)):
        raise ValueError("rel_attention needs contiguous inputs")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v, ke, qe)):
        raise ValueError("rel_attention's bf16 kernel needs 16-byte aligned inputs")
    out = torch.empty_like(v)
    raw = torch.empty((b, w, w), dtype=torch.float32, device=q.device) if need_raw else None
    lib = build.load("rel_attention")
    err = lib.rel_attention_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), ke.data_ptr(),
                                   qe.data_ptr(), out.data_ptr(),
                                   raw.data_ptr() if need_raw else None,
                                   b, w, e, nheads, int(masked), kernels.DTYPE_CODES[q.dtype],
                                   kernels.stream_handle(q.device))
    if err == CUDA_ERROR_INVALID_VALUE:
        raise refused
    kernels.check_launch("rel_attention", err, (b, w, e, nheads, bool(masked), bool(need_raw)))
    return out, raw


# ---------------------------------------------------------------------------
# Trainable form: K4's forward, the analytic backward in PyTorch
# ---------------------------------------------------------------------------
#
# The backward recomputes the attention (nothing is saved beyond the five
# inputs) and realigns the Toeplitz cotangents without the [W, W, E]
# relative tables: the forward adds S(q·keᵀ) and S(k·qe_revᵀ)ᵀ with
# S(X)[i, j] = X[i, W-1-i+j]; the cotangent of S is the inverse shear
# dX[i, r] = dA[i, r-(W-1)+i] (`_unskew`). All heads at once, head-major
# ([H, B, W, ·], so that each product is one batched matmul over the heads),
# in at least f32.


def _skew(x: torch.Tensor, w: int) -> torch.Tensor:
    """[..., W, 2W-1] (rows contiguous) → the [..., W, W] view out[i, j] =
    x[i, W-1-i+j]: row i starts W-1-i columns in, so the view steps 2W-2
    elements a row (the TPU kernel's shear, `_skew_vmem`, as a stride)."""
    r = x.shape[-1]
    return x.as_strided((*x.shape[:-2], w, w), (*x.stride()[:-2], r - 1, 1),
                        x.storage_offset() + w - 1)


def _unskew(da: torch.Tensor, w: int) -> torch.Tensor:
    """[..., W, W] cotangent of the shear → [..., W, 2W-1]: dX[i, r] =
    da[i, r-(W-1)+i], zero where that column lies outside [0, W)
    (`rel_attention.py:162-172`, there a gather with a validity mask; here
    `da` is written through the `_skew` view of a zeroed table)."""
    out = da.new_zeros(*da.shape[:-2], w, 2 * w - 1)
    _skew(out, w).copy_(da)
    return out


def rel_attention_backward(q, k, v, ke, qe, d_out, d_raw, nheads: int, masked: bool = False
                           ) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv, dke, dqe) of `rel_attention` at (q, k, v, ke, qe) for the
    cotangents d_out [B,W,E] and d_raw [B,W,W] (or None), each in its input's
    dtype, summed in at least f32. The port of `_rel_attn_bwd`
    (`rel_attention.py:181-240`), with the heads batched:

        s = q·kᵀ + S(q·keᵀ) + S(k·qe_revᵀ)ᵀ (masked: -1e30 above the diagonal),
        p = softmax(s), dv = pᵀ·dout, dp = dout·vᵀ,
        da = p∘(dp − Σ_j dp∘p) + d_raw (zero above the diagonal when masked),
        dq = da·k + U(da)·ke, dk = daᵀ·q + U(daᵀ)·qe_rev,
        dke = Σ U(da)ᵀ·q, dqe = rev(Σ U(daᵀ)ᵀ·k), U = `_unskew`.
    """
    acc = torch.promote_types(torch.float32, q.dtype)
    b, w, e = q.shape
    r, hd = 2 * w - 1, e // nheads

    def heads(t):  # [B,W,E] → [H, B·W, hd]
        return t.to(acc).reshape(b, w, nheads, hd).permute(2, 0, 1, 3).reshape(nheads, b * w, hd)

    def table(t):  # [2W-1,E] → [H, 2W-1, hd]
        return t.to(acc).reshape(r, nheads, hd).permute(1, 0, 2)

    qh, kh, vh, doh = heads(q), heads(k), heads(v), heads(d_out)
    keh, qeh_rev = table(ke), table(qe.flip(0))
    q4, k4, v4, do4 = (t.view(nheads, b, w, hd) for t in (qh, kh, vh, doh))

    s = q4 @ k4.transpose(-1, -2)                                   # [H,B,W,W]
    s += _skew((qh @ keh.transpose(1, 2)).view(nheads, b, w, r), w)
    s += _skew((kh @ qeh_rev.transpose(1, 2)).view(nheads, b, w, r), w).transpose(-1, -2)
    upper = None
    if masked:
        upper = torch.triu(torch.ones(w, w, dtype=torch.bool, device=q.device), 1)
        s.masked_fill_(upper, MASK_VALUE)
    p = torch.softmax(s, dim=-1)
    del s

    dv = p.transpose(-1, -2) @ do4
    da = do4 @ v4.transpose(-1, -2)                                 # dp
    da -= (da * p).sum(dim=-1, keepdim=True)
    da *= p
    del p
    if d_raw is not None:
        dr = d_raw.to(acc)
        if masked:
            dr = dr.masked_fill(upper, 0.0)
        da += dr

    dq = da @ k4
    dk = da.transpose(-1, -2) @ q4

    def table_grad(dx, x4):
        # Σ over lines and rows of dxᵀ·x, a product per line (W terms) summed over
        # the lines after: one product over B·W rows would sum ~50k terms in f32
        per_line = dx.view(nheads * b, w, r).transpose(1, 2) @ x4.reshape(nheads * b, w, hd)
        return per_line.view(nheads, b, r, hd).sum(dim=1)           # [H, 2W-1, hd]

    dx = _unskew(da, w)                                             # [H,B,W,2W-1]
    dq += (dx.view(nheads, b * w, r) @ keh).view(nheads, b, w, hd)
    dke = table_grad(dx, q4)
    dx = _unskew(da.transpose(-1, -2), w)                           # cotangent of Sᵀ
    dk += (dx.view(nheads, b * w, r) @ qeh_rev).view(nheads, b, w, hd)
    dqe = table_grad(dx, k4).flip(1)
    del dx, da

    def merge(t):  # [H,B,W,hd] → [B,W,E]
        return t.permute(1, 2, 0, 3).reshape(b, w, e)

    def untable(t):  # [H,2W-1,hd] → [2W-1,E]
        return t.permute(1, 0, 2).reshape(r, e)

    return (merge(dq).to(q.dtype), merge(dk).to(k.dtype), merge(dv).to(v.dtype),
            untable(dke).to(ke.dtype), untable(dqe).to(qe.dtype))


class _RelAttention(torch.autograd.Function):
    """`rel_attention` forward (K4 on the card), `rel_attention_backward` backward."""

    @staticmethod
    def forward(ctx, q, k, v, ke, qe, nheads, masked, need_raw):
        out, raw = rel_attention(q, k, v, ke, qe, nheads, masked, need_raw)
        ctx.save_for_backward(q, k, v, ke, qe)
        ctx.nheads, ctx.masked, ctx.need_raw = nheads, masked, need_raw
        return (out, raw) if need_raw else out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, d_out, d_raw=None):
        q, k, v, ke, qe = ctx.saved_tensors
        grads = rel_attention_backward(q, k, v, ke, qe, d_out, d_raw if ctx.need_raw else None,
                                       ctx.nheads, ctx.masked)
        return (*grads, None, None, None)


def rel_attention_trainable(q, k, v, ke, qe, nheads: int, masked: bool = False,
                            need_raw: bool = True
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """`rel_attention` with the analytic backward, for training: the same
    contract, unpadded [2W-1, E] tables. The forward runs K4 on a CUDA tensor
    (its plain version on the CPU) and saves only the five inputs; the
    backward recomputes the attention (`rel_attention_backward`).

    The masked raw entries are -1e30 per head (K4), where the einsum path
    gives -inf. Its consumer, `optimal_transport`, sees the same: the
    Sinkhorn logits there stay below -1e29, and exp of them underflows to 0
    in f32 as exp(-inf) does, so the plan is the same and the cotangent that
    comes back to a masked entry is 0 (the backward zeroes it besides).

    JAX counterpart: `rel_attention_trainable` (a `jax.custom_vjp`).
    """
    res = _RelAttention.apply(q, k, v, ke, qe, nheads, masked, need_raw)
    return res if need_raw else (res, None)
