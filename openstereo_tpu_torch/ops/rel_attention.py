"""STTR relative-position epipolar attention through the hand-written CUDA kernels
(`csrc/rel_attention.cu`: tensor cores for bf16, CUDA cores for f32).

Port of the TPU kernel `openstereo_tpu/ops/pallas/rel_attention.py:
rel_attention` (also reached through `rel_attention_trainable`). The plain
version `rel_attention_plain` is the counterpart of `rel_attention_reference`
in the same file; the wrapper runs it for a tensor on the CPU, and a CUDA
tensor launches the kernel or raises.

Contract, per line b, head h (channels h·hd … h·hd+hd-1), query i, key j:

    s[i,j] = q_i·k_j + q_i·ke[W-1-i+j] + k_j·qe[W-1-i+j]

with q and qe pre-scaled by hd^-1/2 and ke, qe the unpadded [2W-1, E]
tables; `masked` sets s[i,j] = -1e30 (finite, as the TPU kernel) for j > i;
softmax over j; out_i = Σ_j p_ij v_j; raw[i,j] = Σ_h s[i,j] in f32. Layout
is the JAX package's [B, W, E]. Inputs are f32 or bf16, summed in f32, with
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

__all__ = ["rel_attention", "rel_attention_plain", "rel_index", "MASK_VALUE"]

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
    raw = attn.sum(dim=1).float() if need_raw else None
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
    if any(t.dtype != q.dtype for t in tensors) or q.dtype not in kernels.DTYPE_CODES:
        raise TypeError("rel_attention takes q, k, v, ke, qe of one dtype, float32 or "
                        f"bfloat16; got {[t.dtype for t in tensors]}")
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
