"""K4's trainable form (`ops/rel_attention.py:rel_attention_trainable`) vs the
JAX package's `rel_attention_trainable`, on the CPU.

- The backward, `rel_attention_backward`, against JAX's `_rel_attn_bwd`
  called directly on the same residuals and cotangents (it is jnp: no
  Pallas, no interpret mode): f32 at W 16 and a ragged W 13, masked or not,
  with and without the raw cotangent, to 1e-5·max|ref| per gradient; bf16
  against JAX's casts (both sum in f32 and round each gradient to bf16
  once): within one bf16 rounding, 2^-8·|ref| + 1e-5·max|ref|.
- The whole gradient, through torch's autograd, against `jax.grad` of
  `rel_attention_reference` (the einsum formulation), at the tolerance of
  `tests/test_rel_attention.py`: atol 2e-4, rtol 1e-4.
- The masked raw: K4 writes -1e30 above the diagonal, the einsum path -inf.
  `optimal_transport` takes exp of the Sinkhorn logits, and exp(-1e30 + a
  finite shift) underflows to 0 in f32 as exp(-inf) does, so both give the
  same plan and a zero cotangent there; the plan and the gradient through it
  are held against JAX's (einsum raw, -inf) at 1e-5·max|ref|.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from openstereo_tpu.models.sttr import sttr as js
from openstereo_tpu.ops.pallas import rel_attention as jr

from openstereo_tpu_torch.models.sttr import sttr as ts
from openstereo_tpu_torch.models.sttr.transformer import rel_attention_eager

from test_torch_layers import run_jitted_fast
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

tr = importlib.import_module("openstereo_tpu_torch.ops.rel_attention")

NAMES = ("dq", "dk", "dv", "dke", "dqe")


def _inputs(b, w, e, seed, scale=0.5):
    rng = np.random.RandomState(seed)
    qkv = [(rng.randn(b, w, e) * scale).astype(np.float32) for _ in range(3)]
    tables = [(rng.randn(2 * w - 1, e) * scale).astype(np.float32) for _ in range(2)]
    return qkv + tables


def _port_bwd(args, d_out, d_raw, nh, masked, dtype=torch.float32):
    t = [torch.from_numpy(a).to(dtype) for a in args]
    dr = None if d_raw is None else torch.from_numpy(d_raw)
    return tr.rel_attention_backward(*t, torch.from_numpy(d_out).to(dtype), dr, nh, masked)


def _jax_bwd(args, d_out, d_raw, nh, masked, need_raw, dtype=jnp.float32):
    res = tuple(jnp.asarray(a, dtype) for a in args)
    cts = (jnp.asarray(d_out, dtype), None if d_raw is None else jnp.asarray(d_raw))
    return run_jitted_fast(lambda r, c: jr._rel_attn_bwd(nh, masked, need_raw, False, r, c),
                           res, cts)


def _cotangents(b, w, e, need_raw, seed=7):
    rng = np.random.RandomState(seed)
    d_out = rng.randn(b, w, e).astype(np.float32)
    return d_out, (rng.randn(b, w, w).astype(np.float32) if need_raw else None)


@pytest.mark.parametrize("w", [16, 13])
@pytest.mark.parametrize("masked,need_raw", [(False, False), (False, True), (True, False),
                                             (True, True)])
def test_backward_matches_jax_bwd(w, masked, need_raw):
    b, nh, hd = 3, 2, 8
    args = _inputs(b, w, nh * hd, seed=w)
    d_out, d_raw = _cotangents(b, w, nh * hd, need_raw)
    got = _port_bwd(args, d_out, d_raw, nh, masked)
    ref = _jax_bwd(args, d_out, d_raw, nh, masked, need_raw)
    for name, g, r in zip(NAMES, got, ref):
        r = np.asarray(r)
        assert g.dtype == torch.float32 and g.shape == r.shape
        err = np.abs(g.numpy() - r).max() / np.abs(r).max()
        print(f"W {w} masked {masked} raw {need_raw} {name}: {err:.3g} of max|ref|")
        assert err <= 1e-5, name


def test_backward_bf16_matches_jax_casts():
    b, w, nh, hd = 2, 13, 2, 8
    args = _inputs(b, w, nh * hd, seed=3)
    d_out, d_raw = _cotangents(b, w, nh * hd, True)
    got = _port_bwd(args, d_out, d_raw, nh, True, torch.bfloat16)
    ref = _jax_bwd(args, d_out, d_raw, nh, True, True, jnp.bfloat16)
    for name, g, r in zip(NAMES, got, ref):
        assert g.dtype == torch.bfloat16
        g, r = g.float().numpy(), np.asarray(r, np.float32)
        bound = 2.0 ** -8 * np.abs(r) + 1e-5 * np.abs(r).max()
        print(f"bf16 {name}: max-abs {np.abs(g - r).max():.3g}, equal {np.mean(g == r):.4f}")
        assert (np.abs(g - r) <= bound).all(), name


def _port_grads(args, nh, masked, loss_of):
    t = [torch.from_numpy(a).requires_grad_(True) for a in args]
    loss_of(*tr.rel_attention_trainable(*t, nh, masked, True)).backward()
    return [x.grad.numpy() for x in t]


@pytest.mark.parametrize("masked", [False, True])
def test_trainable_grad_matches_jax_reference(masked):
    """As `tests/test_rel_attention.py:79-115`: 0.7·Σ out + 0.3·Σ tanh(raw),
    the masked raw entries left out (-inf in the reference, -1e30 in K4)."""
    b, w, nh, hd = 2, 16, 4, 8
    rng = np.random.RandomState(0)
    args = [rng.randn(b, w, nh * hd).astype(np.float32) for _ in range(3)]
    args += [rng.randn(2 * w - 1, nh * hd).astype(np.float32) for _ in range(2)]

    def loss_ref(*a):
        out, raw = jr.rel_attention_reference(*a, nh, masked=masked)
        r = jnp.where(jnp.isfinite(raw), raw, 0.0)
        return jnp.sum(out * 0.7) + jnp.sum(jnp.tanh(r) * 0.3)

    def loss_port(out, raw):
        r = torch.where(raw > -1e29, raw, torch.zeros_like(raw))
        return (out * 0.7).sum() + (torch.tanh(r) * 0.3).sum()

    ref = run_jitted_fast(jax.grad(loss_ref, argnums=(0, 1, 2, 3, 4)), *map(jnp.asarray, args))
    got = _port_grads(args, nh, masked, loss_port)
    for name, g, r in zip(NAMES, got, ref):
        np.testing.assert_allclose(g, np.asarray(r), atol=2e-4, rtol=1e-4, err_msg=name)


def test_masked_raw_through_optimal_transport():
    """The last layer's masked raw (K4: -1e30; JAX's einsum path: -inf) into
    each package's `optimal_transport`, and the gradient of a weighted sum of
    the plan back to the five inputs."""
    b, w, nh, hd = 3, 12, 2, 8
    args = _inputs(b, w, nh * hd, seed=5, scale=0.3)
    weights = np.random.RandomState(6).rand(1, b, w + 1, w + 1).astype(np.float32)
    phi = np.float32(0.2)

    def plan_ref(*a):
        _, raw = jr.rel_attention_reference(*a, nh, masked=True)
        return js.optimal_transport(raw[None], jnp.asarray(phi))

    ref_plan, ref = run_jitted_fast(jax.value_and_grad(
        lambda *a: (lambda p: (jnp.sum(p * weights), p))(plan_ref(*a)),
        argnums=(0, 1, 2, 3, 4), has_aux=True), *map(jnp.asarray, args))
    ref_plan = np.asarray(ref_plan[1])
    t = [torch.from_numpy(a).requires_grad_(True) for a in args]
    _, raw = tr.rel_attention_trainable(*t, nh, True, True)
    assert (raw.detach().numpy()[:, np.triu(np.ones((w, w)), 1) > 0] == nh * tr.MASK_VALUE).all()
    plan = ts.optimal_transport(raw[None], torch.tensor(phi))
    (plan * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(plan.detach().numpy(), ref_plan, rtol=0,
                               atol=1e-5 * np.abs(ref_plan).max())
    for name, x, r in zip(NAMES, t, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(x.grad.numpy(), r, rtol=0, atol=1e-5 * np.abs(r).max(),
                                   err_msg=name)


@pytest.mark.parametrize("masked", [False, True])
def test_trainable_matches_the_eager_path(masked):
    """The yardstick: the port's einsum path (`rel_attention_eager`, -inf mask)
    under autograd gives the same outputs and gradients."""
    b, w, nh, hd = 2, 11, 2, 8
    args = _inputs(b, w, nh * hd, seed=8)
    d_out, d_raw = _cotangents(b, w, nh * hd, True, seed=9)
    grads = []
    for fn in (tr.rel_attention_trainable, rel_attention_eager):
        t = [torch.from_numpy(a).requires_grad_(True) for a in args]
        out, raw = fn(*t, nh, masked)
        fin = torch.isfinite(raw) & (raw > -1e29)
        ((out * torch.from_numpy(d_out)).sum()
         + torch.where(fin, raw * torch.from_numpy(d_raw), torch.zeros_like(raw)).sum()).backward()
        grads.append([x.grad.numpy() for x in t])
    for name, g, r in zip(NAMES, *grads):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * np.abs(r).max(), err_msg=name)


def test_trainable_forward_and_raw_option():
    b, w, nh, hd = 2, 9, 2, 8
    t = [torch.from_numpy(a) for a in _inputs(b, w, nh * hd, seed=10)]
    out, raw = tr.rel_attention_trainable(*t, nh, True, True)
    ref_out, ref_raw = tr.rel_attention(*t, nh, True, True)
    assert torch.equal(out, ref_out) and torch.equal(raw, ref_raw)
    out2, none = tr.rel_attention_trainable(*[x.requires_grad_(True) for x in t], nh, False, False)
    assert none is None and out2.requires_grad
    out2.sum().backward()
    assert all(x.grad is not None and x.grad.shape == x.shape for x in t)


def test_shifted_unskew_is_caught(monkeypatch):
    """The control of `chip_smoke.py` phase 23: a backward whose `_unskew`
    is shifted by one column fails the comparison with JAX's."""
    b, w, nh, hd = 2, 16, 2, 8
    args = _inputs(b, w, nh * hd, seed=11)
    d_out, d_raw = _cotangents(b, w, nh * hd, True)
    ref = _jax_bwd(args, d_out, d_raw, nh, False, True)
    real = tr._unskew
    monkeypatch.setattr(tr, "_unskew", lambda da, w_: real(da, w_).roll(1, dims=-1))
    got = _port_bwd(args, d_out, d_raw, nh, False)
    errs = {n: np.abs(g.numpy() - np.asarray(r)).max() / np.abs(np.asarray(r)).max()
            for n, g, r in zip(NAMES, got, ref)}
    assert errs["dq"] > 1e-2 and errs["dke"] > 1e-2 and errs["dv"] <= 1e-5, errs


def test_trainable_has_no_fallback_off_the_cpu():
    t = [torch.zeros(1, 4, 16, device="meta") for _ in range(3)]
    t += [torch.zeros(7, 16, device="meta") for _ in range(2)]
    with pytest.raises(RuntimeError, match="no kernel for device"):
        tr.rel_attention_trainable(*t, 2, False, True)
