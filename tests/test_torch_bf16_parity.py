"""Port modules vs flax in bf16, op by op, on the CPU.

Every module type that the ported models run goes through flax's `apply`
with no `jax.jit` (under jit, XLA:CPU drops bf16 roundings of fused
intermediates: exception 3c below) and through the port, from the same
flax variables (carried by `utils/jax_weights.py`) and the same input: an
activation captured from a JAX bf16 layer (a ConvBlock with BatchNorm and
ReLU on seeded numpy data), so both sides get the same bits. The rule: the
outputs are bit-equal except at most 1e-3 of the elements, each by one bf16
unit (two correct f32 sum orders may round a near-tie to two neighbours).

The JAX semantics the port does not copy are asserted as they stand
(ROADMAP §3):
- 3b: JAX's bf16 linear resizes round three times (weights, each axis), the
  port once: the port is one rounding of the f32 resize of its own input;
- 3c: `jax.jit` changes JAX's bf16 cost volume; the port follows op by op;
- 3d: JAX's tap-merged 3D lowerings round partial sums; the 3D checks run
  JAX's "native" lowering (`OPENSTEREO_CONV3D`/`OPENSTEREO_DECONV3D`);
- 3e: flax's bf16 `avg_pool` sums in bf16; the port's mean is one rounding;
- 3f: K2's kernel path folds BN before the bf16 cast, as the Pallas kernel
  does, and so leaves the flax chain; its eager path follows the rule.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flax.linen as nn
import jax
import jax.numpy as jnp

from openstereo_tpu.models import layers as jl
from openstereo_tpu.models.igev import blocks as jblocks
from openstereo_tpu.ops import cost_volume as jcv
from openstereo_tpu.ops import upsample as jup

from openstereo_tpu_torch import ops
from openstereo_tpu_torch.models import layers as tl
from openstereo_tpu_torch.models import set_kernels
from openstereo_tpu_torch.models.coex.coex import cosine_normalize
from openstereo_tpu_torch.models.igev.blocks import BasicConvBN, FeatureAtt
from openstereo_tpu_torch.utils.jax_weights import (FlaxToTorch, basic_conv, feature_att,
                                                    msnet_mv1, msnet_mv2, mv2_residual)

from test_torch_coex import _variables
from test_torch_layers import _random_variables
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

FLIP_SHARE = 1e-3


def to_torch(a) -> torch.Tensor:
    """A JAX bf16 array (channels last) → a torch bf16 tensor (channels at 1), same bits."""
    bits = np.ascontiguousarray(np.moveaxis(np.asarray(a).view(np.int16), -1, 1))
    return torch.from_numpy(bits).view(torch.bfloat16)


def to_jax_layout(t: torch.Tensor) -> np.ndarray:
    """A torch bf16 tensor (channels at 1) → float32 numpy, channels last."""
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


def bf16_units(got: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """|got − ref| in bf16 units of the larger magnitude (0 where equal)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    mag = np.maximum(np.abs(got), np.abs(ref))
    unit = np.exp2(np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 7)
    return np.abs(got - ref) / unit


def assert_bf16_rule(got: torch.Tensor, ref, what: str, max_units=1.0):
    """Bit-equal except at most FLIP_SHARE of the elements, each by one unit
    (with max_units None: the share only)."""
    ref = np.asarray(ref, np.float32)
    got = to_jax_layout(got)
    assert got.shape == ref.shape, what
    units = bf16_units(got, ref)
    share = float((units > 0).mean())
    print(f"{what}: {share:.3g} of {units.size} elements not bit-equal, max {units.max():.3g} units")
    if max_units is not None:
        assert units.max() <= max_units, f"{what}: an element differs by {units.max()} units"
    assert share <= FLIP_SHARE, f"{what}: {share} of the elements differ (cap {FLIP_SHARE})"
    return share


def captured_input(shape, seed, ndim=2):
    """A bf16 activation from a JAX layer (ConvBlock + BN + ReLU, op by op)."""
    rng = np.random.RandomState(seed)
    x = jnp.asarray(rng.randn(*shape[:-1], 5).astype(np.float32)).astype(jnp.bfloat16)
    fm = jl.ConvBlock(shape[-1], 3, norm="batch", act=jax.nn.relu, ndim=ndim,
                      dtype=jnp.bfloat16)
    v = _random_variables(fm, x, seed + 100)
    out = fm.apply(v, x, train=False)
    assert out.dtype == jnp.bfloat16
    return out


def _pair(fm, tm, x, seed, carry, train=False, mutable=False):
    """flax apply (op by op) and the port's forward on the captured input."""
    v = _random_variables(fm, x, seed)
    b = FlaxToTorch(v)
    carry(b)
    tm.load_state_dict(b.finish())
    tm.train(train)
    if mutable:
        ref, _ = fm.apply(v, x, train=True, mutable=["batch_stats"])
    else:
        ref = fm.apply(v, x, train=train)
    with torch.no_grad():
        got = tm(to_torch(x))
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    return got, ref


BF16 = jnp.bfloat16


@pytest.mark.parametrize("case", ["batch eval", "batch training", "instance", "batch stride 2"])
def test_convblock_2d_bf16(case):
    """Op by op, each op on JAX's own input: the conv on the captured input,
    the norm on JAX's conv output, the activation on JAX's norm output, each
    under the rule; the whole block at most FLIP_SHARE of the elements off (a
    flip of the norm's rounding becomes ~1.6 units after leaky_relu's 0.2)."""
    norm = "instance" if case == "instance" else "batch"
    stride, train = 2 if "stride" in case else 1, case == "batch training"
    pad = "replicate" if norm == "instance" else "zeros"
    x = captured_input((2, 24, 20, 16), 1)
    fm = jl.ConvBlock(24, 3, strides=stride, norm=norm, act=jl.leaky_relu(0.2), dtype=BF16,
                      pad_mode=pad)
    tm = tl.ConvBlock(16, 24, 3, stride=stride, norm=norm, act=tl.leaky_relu(0.2), pad_mode=pad)
    v = _random_variables(fm, x, 2)
    b = FlaxToTorch(v)
    b.convbn("", "block") if norm == "batch" else b.conv("", "block.0")
    tm.load_state_dict(b.finish())
    tm.train(train)
    ref, mut = fm.apply(v, x, train=train, capture_intermediates=True,
                        mutable=["intermediates"] + (["batch_stats"] if train else []))
    conv_ref = mut["intermediates"]["conv"]["__call__"][0]
    norm_ref = mut["intermediates"]["bn" if norm == "batch" else "in"]["__call__"][0]
    xt = x if pad == "zeros" else jnp.pad(x, [(0, 0), (1, 1), (1, 1), (0, 0)], mode="edge")
    with torch.no_grad():
        conv = tl.run_conv(to_torch(xt), tm.block[0])
        normed = tl.apply_norm(to_torch(conv_ref), tm.block[1])
        act = tm.act(to_torch(norm_ref))
        whole = tm(to_torch(x))
    assert_bf16_rule(conv, conv_ref, f"ConvBlock 2D {case}: conv")
    assert_bf16_rule(normed, norm_ref, f"ConvBlock 2D {case}: norm")
    assert_bf16_rule(act, ref, f"ConvBlock 2D {case}: activation")
    # the control: the slope 0.2 left unrounded, as the port had it before (ROADMAP 3g)
    with torch.no_grad():
        unrounded = F.leaky_relu(to_torch(norm_ref), negative_slope=0.2)
    share = float((bf16_units(to_jax_layout(unrounded), np.asarray(ref, np.float32)) > 0).mean())
    print(f"ConvBlock 2D {case}: with the slope unrounded {share:.3g} of the elements differ")
    assert share > FLIP_SHARE
    assert_bf16_rule(whole, ref, f"ConvBlock 2D {case}: whole block", max_units=None)


@pytest.mark.parametrize("k", [4, 3])
def test_deconvblock_2d_bf16(k):
    x = captured_input((1, 17, 30, 16), 3)
    fm = jl.DeconvBlock(8, k, 2, norm="batch", act=jax.nn.relu, dtype=BF16)
    tm = tl.DeconvBlock(16, 8, k, norm="batch", act=torch.relu)
    got, ref = _pair(fm, tm, x, 4, lambda b: b.convbn("", "block", deconv=True))
    assert_bf16_rule(got, ref, f"DeconvBlock 2D k{k}")


@pytest.mark.parametrize("stride,expand", [(1, 4), (2, 4), (1, 6)])
def test_mobilev2residual_eager_bf16(stride, expand):
    x = captured_input((2, 24, 20, 16), 5)
    fm = jl.MobileV2Residual(16 if stride == 1 else 32, strides=stride, expanse_ratio=expand,
                             dtype=BF16)
    tm = set_kernels(tl.MobileV2Residual(16, 16 if stride == 1 else 32, stride, expand), False)
    got, ref = _pair(fm, tm, x, 6, lambda b: mv2_residual(b, "", ""))
    assert_bf16_rule(got, ref, f"MobileV2Residual eager, stride {stride}, ratio {expand}")


@pytest.fixture
def native_3d(monkeypatch):
    """JAX's 3D lowering set to "native" (read at trace time), 3d's rule."""
    monkeypatch.setenv("OPENSTEREO_CONV3D", "native")
    monkeypatch.setenv("OPENSTEREO_DECONV3D", "native")


@pytest.mark.parametrize("cin", [8, 32])
def test_convblock_3d_bf16(native_3d, cin):
    x = captured_input((1, 6, 17, 30, cin), 7, ndim=3)
    fm = jl.ConvBlock(16, 3, norm="batch", act=jax.nn.relu, ndim=3, dtype=BF16)
    tm = tl.ConvBlock(cin, 16, 3, norm="batch", act=torch.relu, ndim=3)
    got, ref = _pair(fm, tm, x, 8, lambda b: b.convbn("", "block"))
    assert_bf16_rule(got, ref, f"ConvBlock 3D cin {cin} (native)")


def test_deconvblock_3d_bf16(native_3d):
    x = captured_input((1, 6, 9, 15, 32), 9, ndim=3)
    fm = jl.DeconvBlock(16, 3, 2, norm="batch", ndim=3, dtype=BF16)
    tm = tl.DeconvBlock(32, 16, 3, norm="batch", ndim=3)
    got, ref = _pair(fm, tm, x, 10, lambda b: b.convbn("", "block", deconv=True))
    assert_bf16_rule(got, ref, "DeconvBlock 3D k3 (native)")


# --------------------------------------------------------------- the stated exceptions

def test_3d_tap_lowering_rounds_partial_sums(monkeypatch):
    """3d as it stands: under JAX's default "tap" lowering the 3D conv at cin 32
    leaves the rule (13-20 % of the elements differ), under "native" it keeps it."""
    monkeypatch.setenv("OPENSTEREO_CONV3D", "tap")
    x = captured_input((1, 6, 17, 30, 32), 7, ndim=3)
    fm = jl.ConvBlock(16, 3, norm="batch", act=jax.nn.relu, ndim=3, dtype=BF16)
    tm = tl.ConvBlock(32, 16, 3, norm="batch", act=torch.relu, ndim=3)
    got, ref = _pair(fm, tm, x, 8, lambda b: b.convbn("", "block"))
    share = float((bf16_units(to_jax_layout(got), np.asarray(ref, np.float32)) > 0).mean())
    print(f"3D conv cin 32 under 'tap': {share:.3g} of the elements differ")
    assert share > 0.05


@pytest.mark.parametrize("align_corners,hw,size", [
    (True, (4, 7), (136, 240)), (True, (17, 30), (136, 240)),
    (False, (8, 15), (34, 60)), (False, (17, 30), (34, 60))])
def test_bf16_resize_rounds_once(align_corners, hw, size):
    """3b: the port's bf16 resize is one rounding of the f32 resize of its own
    input (within one unit, at most FLIP_SHARE of the elements off the nearest);
    JAX's rounds three times and differs from it at many elements."""
    x = captured_input((1, *hw, 32), 11)
    xt = to_torch(x)
    if align_corners:
        got = ops.resize_linear_align_corners(xt, size)
        exact = ops.resize_linear_align_corners(xt.float(), size)
        jref = jup.resize_linear_align_corners(x, size, axes=(1, 2))
    else:
        got = ops.resize_bilinear(xt, size)
        exact = ops.resize_bilinear(xt.float(), size)
        jref = jup.resize_bilinear(x, size)
    share = assert_bf16_rule(got, to_jax_layout(exact.bfloat16()), "port vs its f32 resize")
    # what the port did before (ROADMAP 3h): F.interpolate on the bf16 tensor itself
    direct = F.interpolate(xt, size=size, mode="bilinear", align_corners=align_corners)
    units = bf16_units(to_jax_layout(direct), to_jax_layout(exact.bfloat16()))
    print(f"F.interpolate on bf16 itself: {(units > 0).mean():.3g} of the elements off one "
          f"rounding of the f32 resize, by up to {units.max():.3g} units")
    units = bf16_units(to_jax_layout(got), np.asarray(jref, np.float32))
    print(f"JAX's bf16 resize differs from the port at {(units > 0).mean():.3g} of the elements")
    assert (units > 0).mean() > 0.1 > share
    assert (np.abs(np.asarray(jref, np.float32) - to_jax_layout(exact)).max()
            > np.abs(to_jax_layout(got) - to_jax_layout(exact)).max())


def test_jit_changes_jax_bf16_volume():
    """3c: jitted, JAX's bf16 correlation volume keeps its products in f32; op by
    op it rounds each one, and the port follows op by op, bit for bit."""
    rng = np.random.RandomState(12)
    l, r = (jnp.asarray(rng.randn(1, 8, 64, 24).astype(np.float32)).astype(BF16)
            for _ in range(2))
    op_by_op = np.asarray(jcv.correlation_volume(l, r, 48), np.float32)
    jitted = np.asarray(jax.jit(jcv.correlation_volume, static_argnums=2)(l, r, 48), np.float32)
    got = to_jax_layout(ops.correlation_volume(to_torch(l), to_torch(r), 48))
    np.testing.assert_array_equal(got, op_by_op)
    share = float((jitted != op_by_op).mean())
    print(f"jitted vs op-by-op JAX bf16 volume: {share:.3g} of the elements differ")
    assert share > 0.05


@pytest.mark.parametrize("window", [8, 64])
def test_bf16_avg_pool_sums_in_f32(window):
    """3e: flax's bf16 avg_pool sums in bf16; the port's mean is one rounding of
    the f32 mean, and JAX's lies further from it."""
    rng = np.random.RandomState(13)
    x = jnp.asarray((1 + 0.05 * rng.randn(1, 136, 240, 32)).astype(np.float32)).astype(BF16)
    jref = np.asarray(nn.avg_pool(x, (window, window), (window, window)), np.float32)
    xt = to_torch(x)
    got = F.avg_pool2d(xt, window, window)
    exact = F.avg_pool2d(xt.float(), window, window)
    assert_bf16_rule(got, to_jax_layout(exact.bfloat16()), f"port avg_pool {window}")
    err_jax = np.abs(jref - to_jax_layout(exact)).max()
    err_port = np.abs(to_jax_layout(got) - to_jax_layout(exact)).max()
    print(f"avg_pool {window}: JAX off the f32 mean by {err_jax:.3g}, the port by {err_port:.3g}")
    assert err_jax > err_port


def test_k2_kernel_path_folds_bn_before_rounding():
    """3f: with kernels on, MobileV2Residual folds BN into its weights before the
    bf16 cast (as the Pallas kernel does), so it leaves flax's conv→BN chain at
    many elements, where the eager path keeps the rule."""
    x = captured_input((2, 24, 20, 16), 14)
    fm = jl.MobileV2Residual(16, strides=1, expanse_ratio=4, dtype=BF16)
    tm = set_kernels(tl.MobileV2Residual(16, 16, 1, 4), True)
    got, ref = _pair(fm, tm, x, 15, lambda b: mv2_residual(b, "", ""))
    units = bf16_units(to_jax_layout(got), np.asarray(ref, np.float32))
    print(f"K2 path vs flax: {(units > 0).mean():.3g} of the elements differ")
    assert (units > 0).mean() > 0.05
    set_kernels(tm, False)
    with torch.no_grad():
        assert_bf16_rule(tm(to_torch(x)), ref, "the same block, eager")


# --------------------------------------------------- CoEx and MSNet module types

def assert_stages_bf16(fm, v, x, stages, what):
    """Each stage of a port block on JAX's own input of that stage (the flax
    block's captured outputs), under the rule: (flax submodule, the
    submodule whose output feeds it or None for x, the port's stage)."""
    _, mut = fm.apply(v, x, train=False, capture_intermediates=True, mutable=["intermediates"])
    out = lambda name: mut["intermediates"][name]["__call__"][0]  # noqa: E731
    for name, src, stage in stages:
        with torch.no_grad():
            got = stage(to_torch(x if src is None else out(src)))
        assert_bf16_rule(got, out(name), f"{what}: {name}")
    return out


@pytest.mark.parametrize("stride,dilation,cout", [(1, 2, 16), (2, 1, 32), (1, 1, 24)],
                         ids=["dilation 2", "stride 2, downsample", "downsample 16 -> 24"])
def test_mobilev1residual_bf16(stride, dilation, cout):
    """Op by op (each dw and pw stage, the downsample, the residual sum on
    JAX's own inputs) under the rule; the whole block at most FLIP_SHARE of
    the elements off (a one-unit flip inside becomes more where the sum
    cancels)."""
    x = captured_input((2, 24, 20, 16), 20)
    fm = jl.MobileV1Residual(cout, strides=stride, dilation=dilation, dtype=BF16)
    tm = tl.MobileV1Residual(16, cout, stride, dilation)
    got, ref = _pair(fm, tm, x, 21, lambda b: msnet_mv1(b, "", ""))
    what = f"MobileV1Residual stride {stride}, dilation {dilation}, {16} -> {cout}"
    v = _random_variables(fm, x, 21)
    stages = [("conv1_dw", None, lambda t: tl.run_seq(t, tm.conv1[:3])),
              ("conv1_pw", "conv1_dw", lambda t: tl.run_seq(t, tm.conv1[3:])),
              ("conv2_dw", "conv1_pw", lambda t: tl.run_seq(t, tm.conv2[:3])),
              ("conv2_pw", "conv2_dw", lambda t: tl.run_seq(t, tm.conv2[3:]))]
    if tm.downsample is not None:
        stages.append(("downsample", None, lambda t: tl.run_seq(t, tm.downsample)))
    out = assert_stages_bf16(fm, v, x, stages, what)
    skip = x if tm.downsample is None else out("downsample")
    assert_bf16_rule(to_torch(out("conv2_pw")) + to_torch(skip), ref, f"{what}: the sum")
    assert_bf16_rule(got, ref, f"{what}: whole block", max_units=None)


def test_mobilev2residual_seq_eager_bf16():
    """MSNet's key layout of the 2D block, eager path."""
    x = captured_input((2, 24, 20, 16), 22)
    fm = jl.MobileV2Residual(16, strides=1, expanse_ratio=3, dtype=BF16)
    tm = set_kernels(tl.MobileV2ResidualSeq(16, 16, 1, 3), False)
    got, ref = _pair(fm, tm, x, 23, lambda b: msnet_mv2(b, "", ""))
    assert_bf16_rule(got, ref, "MobileV2ResidualSeq eager, ratio 3")


@pytest.mark.parametrize("stride", [1, 2])
def test_mobilev2residual3d_bf16(native_3d, stride):
    """Op by op (pw, dw, pw-linear, each with its BN, on JAX's own inputs)
    under the rule; the whole block at most FLIP_SHARE of the elements off
    (a one-unit flip before the last BN becomes many units where BN's
    shift cancels the conv's output)."""
    x = captured_input((1, 6, 17, 30, 16), 24, ndim=3)
    fm = jl.MobileV2Residual3D(16, strides=stride, expanse_ratio=2, dtype=BF16)
    tm = tl.MobileV2Residual3D(16, 16, stride, 2)
    got, ref = _pair(fm, tm, x, 25, lambda b: msnet_mv2(b, "", ""))
    what = f"MobileV2Residual3D stride {stride} (native)"
    v = _random_variables(fm, x, 25)
    assert_stages_bf16(fm, v, x, [("pw", None, lambda t: tl.run_seq(t, tm.conv[:3])),
                                  ("dw", "pw", lambda t: tl.run_seq(t, tm.conv[3:6])),
                                  ("pw_linear", "dw", lambda t: tl.run_seq(t, tm.conv[6:]))],
                       what)
    assert_bf16_rule(got, ref, f"{what}: whole block", max_units=None)


@pytest.mark.parametrize("case", ["2D", "2D deconv", "3D stride (2,2,2)", "3D no bn, no relu"])
def test_basic_conv_bn_bf16(native_3d, case):
    """BasicConvBN: conv (or the k4 s2 deconv), BN, leaky_relu 0.01."""
    ndim = 3 if case.startswith("3D") else 2
    deconv = "deconv" in case or case.endswith("relu")
    plain = case.endswith("relu")
    shape = (1, 4, 9, 15, 16) if ndim == 3 else (2, 12, 20, 16)
    x = captured_input(shape, 26, ndim=ndim)
    kw = dict(bn=not plain, relu=not plain)
    k, s = (4, 2) if deconv else (3, (2, 2, 2) if ndim == 3 else 1)
    fm = jblocks.BasicConvBN(8, k, s, deconv=deconv, ndim=ndim, dtype=BF16, **kw)
    tm = BasicConvBN(16, 8, k, s, deconv=deconv, ndim=ndim, **kw)
    got, ref = _pair(fm, tm, x, 27, lambda b: basic_conv(b, "", "", bn=not plain, deconv=deconv))
    assert_bf16_rule(got, ref, f"BasicConvBN {case}")


def test_feature_att_bf16():
    """FeatureAtt op by op: the 1×1 conv with bias rounds its conv, then its
    sum with the bias, as flax's `nn.Conv` does (ROADMAP 3i; the fused bias,
    one rounding, fails the rule); the sigmoid is 3j as it stands: the port
    rounds the f32 sigmoid once, XLA:CPU's bf16 `logistic` rounds exp(-x),
    1 + exp(-x) and the quotient, and lies further from the exact value. The
    whole module against the flax program with that one sigmoid rounded once."""
    cv = captured_input((1, 4, 9, 15, 8), 28, ndim=3)
    feat = captured_input((1, 9, 15, 24), 29)
    fm = jblocks.FeatureAtt(8, dtype=BF16)
    v = _variables(fm, (cv, feat), 30)
    b = FlaxToTorch(v)
    feature_att(b, "", "im_att")
    tm = FeatureAtt(8, 24)
    tm.load_state_dict(b.finish())
    ref, mut = fm.apply(v, cv, feat, train=False, capture_intermediates=True,
                        mutable=["intermediates"])
    a0, a1 = (mut["intermediates"][k]["__call__"][0] for k in ("att0", "att1"))
    conv = tm.im_att[1]
    with torch.no_grad():
        att1 = tl.run_conv(to_torch(a0), conv)
        fused = F.conv2d(to_torch(a0), conv.weight.bfloat16(), conv.bias.bfloat16())
        sig = torch.sigmoid(to_torch(a1))
        whole = tm.eval()(to_torch(cv), to_torch(feat))
    assert_bf16_rule(att1, a1, "FeatureAtt: 1x1 conv + bias")
    share = float((bf16_units(to_jax_layout(fused), np.asarray(a1, np.float32)) > 0).mean())
    print(f"FeatureAtt: the bias fused into the conv (one rounding): {share:.3g} differ")
    assert share > FLIP_SHARE
    exact = torch.sigmoid(to_torch(a1).double())
    assert_bf16_rule(sig, to_jax_layout(exact.bfloat16()), "port sigmoid vs its f32 value")
    jsig = jax.nn.sigmoid(a1)
    units = bf16_units(to_jax_layout(sig), np.asarray(jsig, np.float32))
    err_jax = np.abs(np.asarray(jsig, np.float64) - to_jax_layout(exact)).max()
    err_port = np.abs(to_jax_layout(sig).astype(np.float64) - to_jax_layout(exact)).max()
    print(f"XLA:CPU bf16 sigmoid differs from the port at {(units > 0).mean():.3g} of the "
          f"elements; off the exact value by {err_jax:.3g}, the port by {err_port:.3g}")
    assert (units > 0).mean() > 0.05 and err_jax > err_port
    once = jnp.asarray(jax.nn.sigmoid(a1.astype(jnp.float32))).astype(BF16)
    assert_bf16_rule(whole, once[:, None] * cv, "FeatureAtt: whole module, sigmoid rounded once")


def test_coex_cosine_volume_bf16():
    """CoEx's descriptors over their norm (`coex.py:110-111`) and K1's mean
    product × 48 (`:113`: the mean rounded to bf16, then the product rounded
    again), JAX op by op."""
    x, y = (captured_input((1, 6, 40, 48), s) for s in (31, 32))
    xj, yj = (a / (jnp.linalg.norm(a, axis=-1, keepdims=True) + 1e-12) for a in (x, y))
    assert xj.dtype == jnp.bfloat16
    ref = jcv.correlation_volume(xj, yj, 12) * 48
    xt, yt = cosine_normalize(to_torch(x)), cosine_normalize(to_torch(y))
    assert_bf16_rule(xt, xj, "CoEx cosine normalisation")
    # the control: each square rounded to bf16, as the program reads unjitted (3i)
    xb = to_torch(x)
    rounded = xb / (torch.sqrt((xb * xb).sum(1, keepdim=True, dtype=torch.float32).bfloat16())
                    + 1e-12)
    share = float((bf16_units(to_jax_layout(rounded), np.asarray(xj, np.float32)) > 0).mean())
    print(f"CoEx cosine normalisation with the squares rounded: {share:.3g} differ")
    assert share > FLIP_SHARE
    got = ops.corr_volume(xt, yt, 12) * 48
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert_bf16_rule(got, ref, "CoEx K1 volume x 48")
    # the control: the x 48 folded into the mean, one rounding instead of two
    once = (ops.correlation_volume(xt.float(), yt.float(), 12) * 48).bfloat16()
    share = float((bf16_units(to_jax_layout(once), np.asarray(ref, np.float32)) > 0).mean())
    print(f"one rounding of the f32 sum: {share:.3g} of the elements differ")
    assert share > FLIP_SHARE


def test_coex_topk_head_on_bf16_costs():
    """The top-k head on a bf16 cost cast to f32 (`coex.py:174-178`): the
    bf16 grid makes ties common, and the port picks the lower index first,
    as `jax.lax.top_k` does."""
    cost = captured_input((1, 12, 20, 24), 33)  # [B,H,W,D], bf16
    c32 = cost.astype(jnp.float32)
    topv, topi = jax.lax.top_k(c32, 3)
    ties = int(np.sum(np.asarray(topv[..., 1] == topv[..., 2])))
    print(f"bf16 costs: {ties} of {topv[..., 0].size} pixels tie between the 2nd and 3rd value")
    assert ties > 0
    prob = jax.nn.softmax(topv[..., :2], axis=-1)
    ref = np.asarray(jnp.sum(prob * topi[..., :2].astype(jnp.float32), axis=-1))
    c = to_torch(cost).float()
    got = ops.topk_disparity_regression(c, 2)
    # atol: the f32 softmax summed in another order (~2e-6); a tie taken in the
    # other order moves a pixel by p·|i - j| >= ~0.3
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    # the control: ties taken higher index first
    d = c.shape[1]
    flipped = (d - 1) - ops.topk_disparity_regression(c.flip(1), 2)
    assert np.abs(flipped.numpy() - ref).max() > 0.1
