"""Port ops vs the JAX package's ops and Pallas kernels (interpret mode), on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
port is NCHW, the JAX package NHWC, and `to_nhwc`/`to_nchw` below are the
one place the tests transpose between them. f32 on both sides; the
tolerance is the one `tests/test_pallas_kernels.py` uses for the Pallas
kernels against their jnp references (rtol 1e-5, atol 1e-5) unless a test
says otherwise. On the CPU the kernel wrappers run their plain versions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from openstereo_tpu import ops as jops
from openstereo_tpu.ops.pallas import build_gwc_volume_pallas, correlation_volume_pallas
from openstereo_tpu.ops.pallas import fused_mbconv as jfm
from openstereo_tpu.ops.pallas import rel_attention as jra

from openstereo_tpu_torch import ops
from openstereo_tpu_torch.ops import kernels
from openstereo_tpu_torch.ops.fused_mbconv import fold_mbconv

TOL = dict(rtol=1e-5, atol=1e-5)


def to_nhwc(a):
    """Port layout → JAX layout: channel axis 1 → last (numpy or torch)."""
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.moveaxis(a, 1, -1)


def to_nchw(a):
    """JAX layout → port layout: last axis → 1, as a torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


@pytest.mark.parametrize("b,h,w,c,d", [
    (2, 3, 40, 24, 12),   # plain
    (1, 3, 130, 8, 8),    # W ragged against the Pallas tile (128)
    (1, 2, 6, 4, 10),     # planes with d >= W are zero
])
def test_corr_volume_plain_matches_jax_and_pallas(b, h, w, c, d):
    rng = np.random.RandomState(b * 100 + w)
    l = rng.randn(b, h, w, c).astype(np.float32)
    r = rng.randn(b, h, w, c).astype(np.float32)
    ref = np.asarray(jops.correlation_volume(jnp.asarray(l), jnp.asarray(r), d))
    pallas = np.asarray(correlation_volume_pallas(jnp.asarray(l), jnp.asarray(r), d,
                                                  tile_w=128, interpret=True))
    got = ops.corr_volume(to_nchw(l), to_nchw(r), d)
    assert got.shape == (b, d, h, w) and got.dtype == torch.float32
    np.testing.assert_allclose(to_nhwc(got), ref, **TOL)
    np.testing.assert_allclose(to_nhwc(got), pallas, **TOL)
    if d > w:
        assert not got[:, w:].any()


def bf16_features(seed, shape):
    """Two [B,H,W,C] bf16 feature maps from numpy, as JAX arrays."""
    rng = np.random.default_rng(seed)
    return tuple(jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(jnp.bfloat16)
                 for _ in range(2))


def test_corr_volume_bf16_accumulates_in_f32():
    """bf16: each product rounded to bf16 as JAX's `l * r` does, their mean in
    f32, the result rounded once. Bit for bit JAX's jnp builder on the same
    bf16 inputs. The Pallas kernel rounds its G = 1 sum to bf16 before the 1/C
    scale (ROADMAP §3), an error at the scale of the sums, so it is held within
    one bf16 unit at the volume's scale (the unit of max |ref|) at every
    element. The unrounded form (products in f32) differs from JAX at 10 % of
    the elements or more."""
    l, r = bf16_features(3, (1, 4, 32, 24))
    f32 = lambda a: np.asarray(a.astype(jnp.float32))
    ref = f32(jops.correlation_volume(l, r, 8))
    pallas = f32(correlation_volume_pallas(l, r, 8, tile_w=128, interpret=True))
    lt, rt = to_nchw(f32(l)).bfloat16(), to_nchw(f32(r)).bfloat16()
    got = ops.corr_volume(lt, rt, 8)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_nhwc(got.float()), ref)
    unit = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)  # bf16's step at max |ref|
    assert np.abs(to_nhwc(got.float()) - pallas).max() <= unit
    unrounded = to_nhwc(ops.correlation_volume(lt.float(), rt.float(), 8).bfloat16().float())
    assert (unrounded != ref).mean() >= 0.10


@pytest.mark.parametrize("b,h,w,c,d,g", [
    (1, 4, 260, 16, 12, 4),   # the shape of tests/test_pallas_kernels.py
    (2, 3, 37, 24, 20, 2),    # cg = 12, W ragged against the CUDA tile (64)
    (1, 2, 6, 6, 10, 6),      # cg = 1; planes with d >= W are zero
])
def test_gwc_volume_plain_matches_jax_and_pallas(b, h, w, c, d, g):
    """K3's plain version (the wrapper on the CPU) vs `build_gwc_volume` and
    `build_gwc_volume_pallas(..., interpret=True)`, rtol/atol 1e-5."""
    rng = np.random.RandomState(w + c)
    l = rng.randn(b, h, w, c).astype(np.float32)
    r = rng.randn(b, h, w, c).astype(np.float32)
    ref = np.asarray(jops.build_gwc_volume(jnp.asarray(l), jnp.asarray(r), d, g))
    pallas = np.asarray(build_gwc_volume_pallas(jnp.asarray(l), jnp.asarray(r), d, g,
                                                tile_w=128, interpret=True))
    plain = ops.build_gwc_volume(to_nchw(l), to_nchw(r), d, g)
    got = ops.gwc_volume(to_nchw(l), to_nchw(r), d, g)
    assert got.shape == (b, g, d, h, w) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    np.testing.assert_allclose(to_nhwc(got), ref, **TOL)
    np.testing.assert_allclose(to_nhwc(got), pallas, **TOL)
    if d > w:
        assert not got[:, :, w:].any()


def test_gwc_volume_bf16_accumulates_in_f32_and_g1_is_corr():
    """bf16 group-wise volume, cg = 8 (a power of two, so the Pallas kernel's
    sum * (1/cg) is the mean): bit for bit JAX's jnp builder and the Pallas
    kernel on the same bf16 inputs; the unrounded form differs at 10 % of the
    elements or more. With G = 1 it is K1's volume, in f32 and bit for bit in bf16."""
    l, r = bf16_features(7, (1, 4, 32, 24))
    f32 = lambda a: np.asarray(a.astype(jnp.float32))
    ref = f32(jops.build_gwc_volume(l, r, 8, 3))
    pallas = f32(build_gwc_volume_pallas(l, r, 8, 3, tile_w=128, interpret=True))
    lt, rt = to_nchw(f32(l)).bfloat16(), to_nchw(f32(r)).bfloat16()
    got = ops.gwc_volume(lt, rt, 8, 3)
    assert got.dtype == torch.bfloat16
    got = np.moveaxis(got.float().numpy(), 1, -1)  # [B,G,D,H,W] -> [B,D,H,W,G]
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pallas)
    unrounded = np.moveaxis(ops.build_gwc_volume(lt.float(), rt.float(), 8, 3).bfloat16()
                            .float().numpy(), 1, -1)
    assert (unrounded != ref).mean() >= 0.10
    one = ops.gwc_volume(lt.float(), rt.float(), 8, 1)[:, 0]
    np.testing.assert_allclose(one.numpy(), ops.corr_volume(lt.float(), rt.float(), 8).numpy(),
                               **TOL)
    assert torch.equal(ops.gwc_volume(lt, rt, 8, 1)[:, 0], ops.corr_volume(lt, rt, 8))


def test_gwc_volume_checks_inputs():
    a = torch.zeros(1, 6, 2, 8)
    with pytest.raises(ValueError, match="num_groups"):
        ops.gwc_volume(a, a, 4, 4)
    with pytest.raises(ValueError):
        ops.gwc_volume(a, torch.zeros(1, 6, 2, 9), 4, 2)
    with pytest.raises(TypeError):
        ops.gwc_volume(a.double(), a.double(), 4, 2)


def test_concat_volume_matches_jax():
    """Where D <= W: the JAX builder has no d >= W branch (ROADMAP §3)."""
    rng = np.random.RandomState(8)
    l, r = (rng.randn(2, 3, 10, 5).astype(np.float32) for _ in range(2))
    ref = np.asarray(jops.build_concat_volume(jnp.asarray(l), jnp.asarray(r), 10))
    got = ops.build_concat_volume(to_nchw(l), to_nchw(r), 10)
    assert got.shape == (2, 10, 10, 3, 10)
    np.testing.assert_array_equal(to_nhwc(got), ref)
    wide = ops.build_concat_volume(to_nchw(l), to_nchw(r), 14)
    assert torch.equal(wide[:, :, :10], got) and not wide[:, :, 10:].any()


@pytest.mark.parametrize("src,dst", [((3, 4, 5), (12, 16, 20)), ((2, 1, 3), (8, 4, 7))])
def test_resize_trilinear_matches_jax(src, dst):
    x = np.random.RandomState(9).randn(2, 1, *src).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x[:, 0]), (2, *dst), method="trilinear"))
    ref_t = np.asarray(jops.resize_linear_torch(jnp.asarray(x[:, 0]), dst, axes=(1, 2, 3)))
    got = ops.resize_trilinear(torch.from_numpy(x), dst)[:, 0].numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, ref_t, **TOL)
    with pytest.raises(ValueError, match="only upsamples"):
        ops.resize_trilinear(torch.from_numpy(x), (src[0], src[1], src[2] - 1))


@pytest.mark.parametrize("src,dst", [((3, 4, 5), (12, 16, 20)), ((1, 2), (8, 6)), ((4, 6), (7, 9))])
def test_resize_align_corners_matches_jax(src, dst):
    x = np.random.RandomState(10).randn(2, 3, *src).astype(np.float32)
    axes = tuple(range(2, 2 + len(src)))
    ref = np.asarray(jops.resize_linear_align_corners(jnp.asarray(x), dst, axes=axes))
    got = ops.resize_linear_align_corners(torch.from_numpy(x), dst)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def _mbconv_case(seed, b, h, w, cin, ch, cout):
    """Torch-layout convs + eval BatchNorms from numpy, and the same weights
    in the JAX kernel's layouts, folded by each package's own fold_bn."""
    rng = np.random.RandomState(seed)
    # scaled so that both relu6 clamps (at 0 and at 6) are active
    x = (rng.randn(b, h, w, cin) * 3).astype(np.float32)
    convs = [rng.randn(ch, cin, 1, 1) * 0.4, rng.randn(ch, 1, 3, 3) * 0.6,
             rng.randn(cout, ch, 1, 1) * 0.2]
    bns, jax_args = [], []
    for wt in convs:
        n = wt.shape[0]
        bn = torch.nn.BatchNorm2d(n).eval()
        stats = [rng.rand(n) + 0.5, rng.randn(n) * 0.2, rng.randn(n) * 0.2, rng.rand(n) + 0.5]
        with torch.no_grad():
            for t, v in zip((bn.weight, bn.bias, bn.running_mean, bn.running_var), stats):
                t.copy_(torch.from_numpy(v))
        bns.append(bn)
        # JAX kernel layout: Cout last, spatial taps flattened tap-major
        k = wt.reshape(n, -1).T.astype(np.float32)  # [Cin or 9, Cout]
        jax_args += list(jfm.fold_bn(k, *[np.float32(s) for s in stats]))
    port_args = fold_mbconv(torch.from_numpy(convs[0]).float(), bns[0],
                            torch.from_numpy(convs[1]).float(), bns[1],
                            torch.from_numpy(convs[2]).float(), bns[2], dtype=torch.float32)
    return x, port_args, [jnp.asarray(a, jnp.float32) for a in jax_args]


@pytest.mark.parametrize("residual", [True, False])
def test_fused_mbconv_plain_matches_jax_and_pallas(residual):
    cout = 8 if residual else 12
    x, port_args, jax_args = _mbconv_case(0, 1, 10, 20, 8, 32, cout)
    ref = np.asarray(jfm.mbconv_reference(jnp.asarray(x), *jax_args, residual=residual))
    pallas = np.asarray(jfm.fused_mbconv(jnp.asarray(x), *jax_args, tile_h=8, tile_w=128,
                                         residual=residual, interpret=True))
    for a, j in zip(port_args, jax_args):  # port fold_bn + layout == JAX fold_bn
        np.testing.assert_allclose(a.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)
    plain = ops.mbconv_plain(to_nchw(x), *port_args, residual=residual)
    got = ops.fused_mbconv(to_nchw(x), *port_args, residual=residual)
    assert got.shape == (1, cout, 10, 20)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    np.testing.assert_allclose(to_nhwc(got), ref, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(to_nhwc(got), pallas, rtol=1e-5, atol=1e-4)


def test_fused_mbconv_checks_inputs():
    x, args, _ = _mbconv_case(1, 1, 4, 4, 8, 16, 12)
    with pytest.raises(ValueError, match="residual"):
        ops.fused_mbconv(to_nchw(x), *args, residual=True)
    with pytest.raises(TypeError):
        ops.fused_mbconv(to_nchw(x).double(), *args, residual=False)
    with pytest.raises(ValueError, match="w1"):
        ops.fused_mbconv(to_nchw(x), args[0][:4], *args[1:], residual=False)
    with pytest.raises(TypeError, match="b1"):
        ops.fused_mbconv(to_nchw(x), args[0], args[1].bfloat16(), *args[2:], residual=False)


def test_corr_volume_checks_inputs():
    a = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError):
        ops.corr_volume(a, torch.zeros(1, 4, 2, 9), 4)
    with pytest.raises(TypeError):
        ops.corr_volume(a.double(), a.double(), 4)


ZERO_COUNTS = {"corr_volume": 0, "fused_mbconv": 0, "rel_attention": 0, "gwc_volume": 0}


def test_cpu_wrappers_launch_nothing():
    kernels.reset_launch_counts()
    a = torch.randn(1, 4, 2, 8)
    ops.corr_volume(a, a, 4)
    ops.gwc_volume(a, a, 4, 2)
    x = torch.randn(1, 6, 8)
    ops.rel_attention(x, x, x, torch.randn(11, 8), torch.randn(11, 8), 2)
    assert kernels.launch_counts == ZERO_COUNTS
    assert not any(kernels.launch_shapes.values())


def test_check_launch_counts_by_shape():
    kernels.reset_launch_counts()
    for shape in ((1, 4, 2, 8, 4), (1, 4, 2, 8, 4), (2, 4, 2, 8, 4)):
        kernels.check_launch("corr_volume", 0, shape)
    assert kernels.launch_counts["corr_volume"] == 3
    assert kernels.launch_shapes["corr_volume"] == {(1, 4, 2, 8, 4): 2, (2, 4, 2, 8, 4): 1}
    with pytest.raises(RuntimeError, match="cudaError_t 2"):
        kernels.check_launch("fused_mbconv", 2, (1, 1, 1, 1, 1, 1, True))
    assert kernels.launch_counts["fused_mbconv"] == 0
    kernels.reset_launch_counts()
    assert kernels.launch_counts == ZERO_COUNTS
    assert not any(kernels.launch_shapes.values())


def test_fold_bn_matches_jax():
    rng = np.random.RandomState(1)
    k = rng.randn(16, 8, 3, 3).astype(np.float32)
    stats = [rng.rand(16) + 0.5, rng.randn(16), rng.randn(16), rng.rand(16) + 0.1]
    kf, bf = ops.fold_bn(torch.from_numpy(k), *[torch.from_numpy(s) for s in stats])
    jk, jb = jfm.fold_bn(k.transpose(2, 3, 1, 0), *stats)
    np.testing.assert_allclose(kf.numpy().transpose(2, 3, 1, 0), jk, rtol=1e-6)
    np.testing.assert_allclose(bf.numpy(), jb, rtol=1e-6, atol=1e-6)


def test_disparity_regression_matches_jax():
    rng = np.random.RandomState(2)
    logits = rng.randn(2, 5, 7, 12).astype(np.float32)
    prob = np.asarray(jnp.exp(logits) / jnp.exp(logits).sum(-1, keepdims=True))
    ref = np.asarray(jops.disparity_regression(jnp.asarray(prob), 12))
    got = ops.disparity_regression(to_nchw(prob), 12)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_unfold3x3_matches_jax():
    x = np.random.RandomState(3).randn(2, 5, 6).astype(np.float32)
    ref = np.asarray(jops.unfold3x3(jnp.asarray(x)))
    np.testing.assert_array_equal(to_nhwc(ops.unfold3x3(torch.from_numpy(x))), ref)


def test_context_upsample_matches_jax():
    rng = np.random.RandomState(4)
    disp = (rng.rand(2, 4, 6) * 10).astype(np.float32)
    w = rng.rand(2, 16, 24, 9).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    ref = np.asarray(jops.context_upsample(jnp.asarray(disp), jnp.asarray(w)))
    got = ops.context_upsample(torch.from_numpy(disp), to_nchw(w))
    assert got.shape == (2, 16, 24)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def _rel_attention_case(seed, b, w, e):
    """q, k, v [B,W,E] and the [2W-1,E] tables, scaled as `tests/test_rel_attention.py`."""
    rng = np.random.RandomState(seed)
    return [(rng.randn(*shape) * 0.2).astype(np.float32)
            for shape in [(b, w, e)] * 3 + [(2 * w - 1, e)] * 2]


@pytest.mark.parametrize("w,masked,need_raw", [
    (24, False, True), (40, True, True),
    (37, True, True), (37, False, False),  # W ragged against the kernel's 32-row tile
])
def test_rel_attention_plain_matches_jax_and_pallas(w, masked, need_raw):
    """K4's plain version (the wrapper on the CPU) vs `rel_attention_reference`
    and the Pallas kernel in interpret mode, at the tolerances of
    `tests/test_rel_attention.py` (out 1e-5, raw 1e-4 on finite entries)."""
    args = _rel_attention_case(w, 2, w, 16)
    ref, ref_raw = jra.rel_attention_reference(*map(jnp.asarray, args), 4, masked=masked)
    pallas, pallas_raw = jra.rel_attention(*map(jnp.asarray, args), nheads=4, masked=masked,
                                           need_raw=need_raw, interpret=True)
    got, raw = ops.rel_attention(*map(torch.from_numpy, args), 4, masked, need_raw)
    assert got.shape == (2, w, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    if not need_raw:
        assert raw is None and pallas_raw is None
        return
    fin = np.abs(np.asarray(ref_raw)) < 1e20
    assert fin.all() != masked and (raw.numpy()[~fin] < -1e29).all()
    for r in (ref_raw, pallas_raw):
        np.testing.assert_allclose(raw.numpy()[fin], np.asarray(r)[fin], rtol=1e-4, atol=1e-4)


def _rel_attention_p_rounded(q, k, v, ke, qe, nheads, masked):
    """The contract in f32 from f32 copies, with only p rounded to bf16 before
    p·v (where the TPU kernel rounds it): an independent f32 reference."""
    b, w, e = q.shape
    hd = e // nheads
    i, j = np.arange(w)[:, None], np.arange(w)[None, :]
    idx = torch.from_numpy(w - 1 - i + j)
    qh, kh, vh = (t.float().reshape(b, w, nheads, hd) for t in (q, k, v))
    k_r, q_r = (t.float()[idx].reshape(w, w, nheads, hd) for t in (ke, qe))
    s = (torch.einsum("bihc,bjhc->bhij", qh, kh) + torch.einsum("bihc,ijhc->bhij", qh, k_r)
         + torch.einsum("bjhc,ijhc->bhij", kh, q_r))
    if masked:
        s = s.masked_fill(torch.from_numpy(j > i), -1e30)
    p = torch.softmax(s, dim=-1).bfloat16().float()
    return torch.einsum("bhij,bjhc->bihc", p, vh).reshape(b, w, e), s.sum(dim=1)


def test_rel_attention_bf16_accumulates_in_f32():
    args = [torch.from_numpy(a).bfloat16() for a in _rel_attention_case(5, 2, 20, 32)]
    got, raw = ops.rel_attention(*args, 2, masked=True)
    assert got.dtype == torch.bfloat16 and raw.dtype == torch.float32
    ref, ref_raw = ops.rel_attention_plain(*[a.float() for a in args], 2, masked=True)
    np.testing.assert_array_equal(raw.numpy(), ref_raw.numpy())
    # sums in f32 from the bf16 inputs; p rounded to bf16 before p·v, as the
    # TPU kernel rounds it; then one bf16 rounding of out
    ref, ref_raw = _rel_attention_p_rounded(*args, 2, masked=True)
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(), rtol=8e-3, atol=1e-6)
    fin = ref_raw.abs() < 1e20
    np.testing.assert_allclose(raw[fin].numpy(), ref_raw[fin].numpy(), rtol=1e-5, atol=1e-5)


def assert_bf16_equal_but_few(got, want, most):
    """bf16 `got` equals `want` (bf16 values held as f32) at all but at most
    `most` elements, and there by one bf16 unit. The plain versions and the
    Pallas kernels in interpret mode do the same f32 sums and round at the
    same places, in other orders, which may round a near-tie the other way;
    without the roundings (h, d, p kept in f32) hundreds of elements differ
    at the shapes below."""
    got, want = got.float(), torch.as_tensor(np.asarray(want, np.float32))
    differ = got != want
    assert int(differ.sum()) <= most, f"{int(differ.sum())} elements differ"
    near = want.abs().bfloat16()
    ulp = (near.view(torch.int16) + 1).view(torch.bfloat16).float() - near.float()
    assert bool(((got - want).abs() <= ulp)[differ].all())


def test_rel_attention_bf16_plain_rounds_like_pallas():
    """K4's bf16 plain version rounds p to bf16 before p·v as the Pallas kernel
    does (`rel_attention.py:78-80`); raw is f32 (rtol/atol 1e-5)."""
    args = [(a * 2.5).astype(np.float32) for a in _rel_attention_case(11, 2, 24, 32)]
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in args]
    pallas, pallas_raw = jra.rel_attention(*jargs, nheads=4, masked=True, need_raw=True,
                                           interpret=True)
    got, raw = ops.rel_attention_plain(*[torch.from_numpy(a).bfloat16() for a in args], 4,
                                       masked=True)
    assert got.dtype == torch.bfloat16
    assert_bf16_equal_but_few(got, pallas, most=2)
    # p kept in f32 (the plain version on f32 copies) fails that check
    unrounded, _ = ops.rel_attention_plain(*[torch.from_numpy(a).bfloat16().float()
                                             for a in args], 4, masked=True)
    with pytest.raises(AssertionError, match=r"^\d{3,} elements differ"):
        assert_bf16_equal_but_few(unrounded.bfloat16(), pallas, most=2)
    pallas_raw = np.asarray(pallas_raw)
    fin = np.abs(pallas_raw) < 1e20
    assert not fin.all() and (raw.numpy()[~fin] < -1e29).all()
    np.testing.assert_allclose(raw.numpy()[fin], pallas_raw[fin], rtol=1e-5, atol=1e-5)


def test_fused_mbconv_bf16_plain_rounds_like_pallas():
    """K2's bf16 plain version keeps h and d in bf16 as the Pallas kernel does
    (`fused_mbconv.py:79` and `:89`)."""
    rng = np.random.RandomState(12)
    b, h, w, cin, ch, cout = 1, 8, 16, 32, 192, 32
    x = (rng.randn(b, h, w, cin) * 3).astype(np.float32)
    ws = [rng.randn(cin, ch) * cin ** -0.5, rng.randn(ch) * 0.5, rng.randn(9, ch) * 0.6,
          rng.randn(ch) * 0.1, rng.randn(ch, cout) * ch ** -0.5, rng.randn(cout) * 0.1]
    ws = [a.astype(np.float32) for a in ws]
    jw = [jnp.asarray(a, jnp.bfloat16 if i % 2 == 0 else jnp.float32) for i, a in enumerate(ws)]
    pallas = jfm.fused_mbconv(jnp.asarray(x, jnp.bfloat16), *jw, tile_h=8, tile_w=128,
                              residual=True, interpret=True)
    tw = [torch.from_numpy(a).bfloat16() if i % 2 == 0 else torch.from_numpy(a)
          for i, a in enumerate(ws)]
    got = ops.mbconv_plain(to_nchw(x).bfloat16(), *tw, residual=True)
    assert got.dtype == torch.bfloat16
    assert_bf16_equal_but_few(torch.from_numpy(to_nhwc(got.float())), pallas, most=2)
    # h and d kept in f32 (the plain version on f32 copies) fail that check
    unrounded = ops.mbconv_plain(to_nchw(x).bfloat16().float(), *[t.float() for t in tw],
                                 residual=True)
    with pytest.raises(AssertionError, match=r"^\d{3,} elements differ"):
        assert_bf16_equal_but_few(torch.from_numpy(to_nhwc(unrounded)).bfloat16(), pallas,
                                  most=2)


def test_rel_attention_checks_inputs():
    q, k, v, ke, qe = map(torch.from_numpy, _rel_attention_case(6, 1, 8, 16))
    with pytest.raises(ValueError, match="2W-1"):
        ops.rel_attention(q, k, v, ke[:-1], qe, 2)
    with pytest.raises(ValueError, match="divisible"):
        ops.rel_attention(q, k, v, ke, qe, 3)
    with pytest.raises(TypeError):
        ops.rel_attention(q, k.bfloat16(), v, ke, qe, 2)
    with pytest.raises(ValueError, match="equal"):
        ops.rel_attention(q, k[:, :4], v, ke, qe, 2)


def test_rel_attention_kernel_limits():
    """What the f32 CUDA-core kernel takes: head widths 8..64, and W up to
    where its score tile fills a block's shared memory (>= 416, a 1248-wide
    frame). The bf16 tensor-core kernels' limits are the launcher's own (any
    W without raw; with raw, W up to where the raw tile fills shared memory):
    chip_smoke.py runs them at W 640 and 448 and has W 2048 with raw refused."""
    from openstereo_tpu_torch.ops.rel_attention import HEAD_DIMS, SMEM_LIMIT, smem_bytes

    for hd in HEAD_DIMS:
        assert smem_bytes(416, hd, need_raw=True) <= SMEM_LIMIT
    assert smem_bytes(2048, 16, need_raw=True) > SMEM_LIMIT
