"""The bf16 agreement check that chip_smoke.py holds K2 and K4 to on the card
(`bf16_close_flips` with `k2_flip_allowance` / `k4_flip_allowance`), run on
the CPU against implementations whose rounding is known.

The check lets a small share of output elements miss `bf16_close`, each by no
more than what rounding an intermediate (h, d or p) the other way would move
it, because two correct sum orders may round a near-tie differently. These
tests show where that leaves it: the plain arithmetic summed in f64, which
rounds h, d and p where the TPU kernels do, passes; controls that round in the
wrong place (K2: h or d left in f32; K4: p left in f32, or exp(s - m) rounded
before the division by the row sum) fail. The same for the K1/K3 check
(`volume_bf16_check`): products rounded to bf16 and summed in f64 pass, the
unrounded products fail.
"""

import pytest
import torch
import torch.nn.functional as F

import chip_smoke as cs
from openstereo_tpu_torch import ops
from openstereo_tpu_torch.ops.rel_attention import rel_index

CPU = torch.device("cpu")


def k2_f64(x, args, residual):
    """K2's arithmetic summed in f64, h and d rounded to bf16 as the TPU kernel does."""
    w1, b1, dw, b2, w2, b3 = (a.double() for a in args)
    xf, ch = x.double(), w1.shape[1]
    h = (torch.einsum("bchw,cd->bdhw", xf, w1) + b1[:, None, None]).clamp(0, 6)
    h = h.bfloat16().double()
    d = F.conv2d(h, dw.t().reshape(ch, 1, 3, 3), b2, padding=1, groups=ch).clamp(0, 6)
    d = d.bfloat16().double()
    y = torch.einsum("bchw,cd->bdhw", d, w2) + b3[:, None, None]
    return (y + xf if residual else y).bfloat16()


def k4_f64(args, nh, masked):
    """K4's arithmetic summed in f64, p rounded to bf16 before p·v as the TPU kernel does."""
    q, k, v, ke, qe = (a.double() for a in args)
    b, w, e = q.shape
    hd, idx = e // nh, rel_index(w)
    qh, kh, vh = (t.reshape(b, w, nh, hd) for t in (q, k, v))
    k_r, q_r = (t[idx].reshape(w, w, nh, hd) for t in (ke, qe))
    s = (torch.einsum("bihc,bjhc->bhij", qh, kh) + torch.einsum("bihc,ijhc->bhij", qh, k_r)
         + torch.einsum("bjhc,ijhc->bhij", kh, q_r))
    if masked:
        s = s.masked_fill(torch.triu(torch.ones(w, w, dtype=torch.bool), 1), -1e30)
    p = torch.softmax(s, dim=-1).bfloat16().double()
    return torch.einsum("bhij,bjhc->bihc", p, vh).reshape(b, w, e).bfloat16()


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("impl,passes", [("f64 sums", True), ("h f32", False), ("d f32", False)])
def test_k2_bf16_check(impl, passes, residual):
    """At a LightStereo-S main-path shape (34x60, 64 -> 384 -> 64) cut to one
    image: f64 sums pass; h or d left in f32 fail (they miss `bf16_close` on
    ~4-8 % of the elements, the cap is 1e-4)."""
    x, args = cs.k2_inputs((1, 34, 60, 64, 384, 64, True), CPU, torch.bfloat16,
                           torch.Generator().manual_seed(2))
    ref = ops.mbconv_plain(x, *args, residual=residual)
    allowance = cs.k2_flip_allowance(x, args)
    if impl == "f64 sums":
        got = k2_f64(x, args, residual)
    else:
        got = cs.k2_misrounded(x, args, residual, impl != "h f32", impl != "d f32")
    rejected, _ = cs.rejected(got, ref, allowance, cs.K2_FLIP_SHARE)
    assert rejected != passes


@pytest.mark.parametrize("masked,impl,passes", [
    (False, "f64 sums", True), (True, "f64 sums", True),
    (False, "exp before /l", False), (True, "exp before /l", False), (True, "p f32", False),
])
def test_k4_bf16_check(masked, impl, passes):
    """At STTR's main-path width (W 320, E 128, 8 heads) on 8 lines: f64 sums
    pass; rounding exp(s - m) before the division fails, and so does p left
    in f32 on a masked launch (unmasked, p ~ 1/W is too small for its rounding
    to show in 8 lines; the card runs both controls at the full main shapes)."""
    g = torch.Generator().manual_seed(4)
    args = [a.bfloat16() for a in cs.k4_inputs((8, 320, 128, 8), CPU, g)]
    ref, _ = ops.rel_attention_plain(*args, 8, masked, False)
    allowance = cs.k4_flip_allowance(args, 8, masked)
    got = k4_f64(args, 8, masked) if impl == "f64 sums" else cs.k4_misrounded(args, 8, masked,
                                                                              impl)
    rejected, _ = cs.rejected(got, ref, allowance, cs.K4_FLIP_SHARE)
    assert rejected != passes


@pytest.mark.parametrize("shape", [(1, 320, 2, 240, 48, 40), (1, 24, 4, 240, 48, 1)],
                         ids=["K3 rows", "K1 rows"])
@pytest.mark.parametrize("impl,passes", [("f64 sums", True), ("unrounded", False)])
def test_volume_bf16_check(shape, impl, passes):
    """Two main-path rows of GwcNet's and LightStereo-S's volumes: products
    rounded to bf16 and summed in f64 pass `volume_bf16_check`; products in
    f32 (the form the port's plain versions had) fail it, on ~1/3 of the
    elements against a cap of 1e-4."""
    b, c, h, w, d, g = shape
    gen = torch.Generator().manual_seed(sum(shape))
    left, right = (torch.randn(b, c, h, w, generator=gen).bfloat16() for _ in range(2))
    ref = ops.build_gwc_volume(left, right, d, g)
    got = torch.zeros(b, g, d, h, w, dtype=torch.float64)
    for k in range(min(d, w)):
        if impl == "f64 sums":  # each product rounded to bf16
            prod = (left[..., k:] * right[..., :w - k]).double()
        else:  # exact products, as f32 gives them
            prod = left[..., k:].double() * right[..., :w - k].double()
        got[:, :, k, :, k:] = prod.reshape(b, g, c // g, h, w - k).sum(dim=2) / (c // g)
    rejected, _ = cs.volume_rejected(got.bfloat16(), ref)
    assert rejected != passes
