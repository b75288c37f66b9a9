"""Port layers vs the flax layers of the JAX package, eval mode, f32, on the CPU.

Flax variables are made from numpy (seeded), carried to the port with
`openstereo_tpu_torch.utils.jax_weights`, and both sides run the same
input. Tolerance rtol 1e-4, atol 1e-5, as `tests/test_layer_parity.py`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from openstereo_tpu.models import layers as jl

from openstereo_tpu_torch.models import layers as tl
from openstereo_tpu_torch.models import set_kernels
from openstereo_tpu_torch.utils.jax_weights import FlaxToTorch, mv2_residual

from test_torch_ops import to_nchw, to_nhwc
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

TOL = dict(rtol=1e-4, atol=1e-5)


def _random_variables(module, x, seed, train=False):
    """flax variables of `module` at input x, every leaf drawn from numpy:
    kernels ~ N(0, 1/fan_in), BN scale/var around 1, biases/means small.
    `train=True` draws the variables of the training graph (GwcNet's
    training heads)."""
    shapes = jax.eval_shape(lambda a: module.init(jax.random.key(0), a, train=train), x)
    return _random_like(shapes, seed)


def _random_variables_via(convert, port_model, seed):
    """flax variables drawn as `_random_variables` draws them, in the tree
    that the JAX package's converter `convert` makes of `port_model`'s
    state_dict: the training graph's variables, without tracing flax's
    init (seconds per whole model)."""
    tree = convert({k: v.numpy() for k, v in port_model.state_dict().items()})
    return _random_like(tree, seed)


def run_jitted_fast(fn, *args):
    """fn(*args) jitted, its XLA:CPU backend at optimisation level 0: a
    whole model compiles in about half the time and runs a little slower;
    the same HLO, so the same sums in f32 up to the machine code's order."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def _random_like(shapes, seed):
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = str(path[-1])
        if "kernel" in name:
            a = rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif "scale" in name or "var" in name:
            a = rng.rand(*s.shape) + 0.5
        else:
            a = rng.randn(*s.shape) * 0.1
        return np.asarray(a, np.float32)  # a 0-d draw (CFNet's range scalars) is a float

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _assert_matches_flax(got, module, variables, x):
    ref = np.asarray(module.apply(variables, jnp.asarray(x), train=False))
    print(f"{type(module).__name__} max-abs {np.abs(to_nhwc(got) - ref).max():.3g}")
    np.testing.assert_allclose(to_nhwc(got), ref, **TOL)


def _load(module, sd):
    module.load_state_dict(sd)
    return module.eval()


@pytest.mark.parametrize("norm,pad_mode,stride", [
    ("batch", "zeros", 1), ("batch", "zeros", 2), ("instance", "replicate", 1)])
def test_convblock_matches_flax(norm, pad_mode, stride):
    x = np.random.RandomState(0).randn(2, 12, 10, 6).astype(np.float32)
    act = tl.leaky_relu(0.2) if norm == "batch" else None
    jact = jl.leaky_relu(0.2) if norm == "batch" else None
    fm = jl.ConvBlock(8, 3, strides=stride, norm=norm, act=jact, pad_mode=pad_mode)
    v = _random_variables(fm, jnp.asarray(x), 1)
    b = FlaxToTorch(v)
    if norm == "batch":
        b.convbn("", "block")
    else:
        b.conv("", "block.0")
    tm = _load(tl.ConvBlock(6, 8, 3, stride=stride, norm=norm, act=act, pad_mode=pad_mode),
               b.finish())
    with torch.no_grad():
        got = tm(to_nchw(x))
    _assert_matches_flax(got, fm, v, x)


@pytest.mark.parametrize("k", [4, 3])
def test_deconvblock_matches_flax(k):
    x = np.random.RandomState(2).randn(1, 5, 7, 6).astype(np.float32)
    fm = jl.DeconvBlock(4, k, 2, norm="batch", act=jax.nn.relu)
    v = _random_variables(fm, jnp.asarray(x), 3)
    b = FlaxToTorch(v)
    b.convbn("", "block", deconv=True)
    tm = _load(tl.DeconvBlock(6, 4, k, norm="batch", act=torch.relu), b.finish())
    with torch.no_grad():
        got = tm(to_nchw(x))
    assert got.shape == (1, 4, 10, 14)
    _assert_matches_flax(got, fm, v, x)


@pytest.mark.parametrize("stride,dilation,k,act", [(1, 1, 3, True), (2, 1, 3, True),
                                                    (1, 2, 3, False), (1, 1, 1, False)])
def test_convblock3d_matches_flax(stride, dilation, k, act):
    """3D ConvBlock (NCDHW) vs flax's (NDHWC, tap-merged on the CPU)."""
    x = np.random.RandomState(6).randn(1, 6, 8, 10, 5).astype(np.float32)
    fm = jl.ConvBlock(7, k, strides=stride, dilation=dilation, norm="batch",
                      act=jax.nn.relu if act else None, ndim=3)
    v = _random_variables(fm, jnp.asarray(x), 7)
    b = FlaxToTorch(v)
    b.convbn("", "block")
    tm = _load(tl.ConvBlock(5, 7, k, stride=stride, dilation=dilation, norm="batch",
                            act=torch.relu if act else None, ndim=3), b.finish())
    with torch.no_grad():
        got = tm(to_nchw(x))
    _assert_matches_flax(got, fm, v, x)


@pytest.mark.parametrize("k", [3, 4])
def test_deconvblock3d_matches_flax(k):
    """3D DeconvBlock: k3 s2 p1 op1 (the hourglasses') and k4 s2 p1."""
    x = np.random.RandomState(8).randn(1, 3, 4, 5, 6).astype(np.float32)
    fm = jl.DeconvBlock(4, k, 2, norm="batch", ndim=3)
    v = _random_variables(fm, jnp.asarray(x), 9)
    b = FlaxToTorch(v)
    b.convbn("", "block", deconv=True)
    tm = _load(tl.DeconvBlock(6, 4, k, norm="batch", ndim=3), b.finish())
    with torch.no_grad():
        got = tm(to_nchw(x))
    assert got.shape == (1, 4, 6, 8, 10)
    _assert_matches_flax(got, fm, v, x)


def test_run_seq_walks_reference_sequentials():
    torch.manual_seed(1)
    seq = torch.nn.Sequential(tl.convbn(3, 4, ndim=3), torch.nn.ReLU(),
                              torch.nn.Sequential(tl.convbn(4, 2, 1, ndim=3))).eval()
    x = torch.randn(1, 3, 4, 5, 6)
    with torch.no_grad():
        np.testing.assert_allclose(tl.run_seq(x, seq).numpy(), seq(x).numpy(), rtol=1e-6,
                                   atol=1e-6)
        assert tl.run_seq(x.bfloat16(), seq).dtype == torch.bfloat16


@pytest.mark.parametrize("inp,oup,stride,kernels", [
    (8, 8, 1, True), (8, 8, 1, False),    # residual: fused path and eager path
    (8, 12, 1, True),                     # stride 1, no residual (fused)
    (8, 16, 2, True),                     # strided: always eager
])
def test_mobilev2residual_matches_flax(inp, oup, stride, kernels):
    x = np.random.RandomState(4).randn(1, 8, 12, inp).astype(np.float32)
    fm = jl.MobileV2Residual(oup, strides=stride, expanse_ratio=4)
    v = _random_variables(fm, jnp.asarray(x), 5)
    b = FlaxToTorch(v)
    mv2_residual(b, "", "")
    tm = set_kernels(_load(tl.MobileV2Residual(inp, oup, stride, 4), b.finish()), kernels)
    assert tm.fusable == (stride == 1) and tm.use_res == (stride == 1 and inp == oup)
    with torch.no_grad():
        got = tm(to_nchw(x))
    _assert_matches_flax(got, fm, v, x)


def test_mobilev2residual_refolds_after_weight_update():
    """The folded weights follow the module's parameters (per version)."""
    torch.manual_seed(0)
    m = tl.MobileV2Residual(4, 4, 1, 2).eval()
    x = torch.randn(1, 4, 5, 6)
    with torch.no_grad():
        first = m(x)
        m.pwliner[1].weight.mul_(2.0)
        second = m(x)
        set_kernels(m, False)
        eager = m(x)
    assert not torch.allclose(first, second)
    np.testing.assert_allclose(second.numpy(), eager.numpy(), rtol=1e-5, atol=1e-6)


def test_siamese_splits_outputs():
    left, right = torch.randn(2, 3, 4, 4), torch.randn(2, 3, 4, 4)
    (l1, l2), (r1, r2) = tl.siamese(lambda t: [t * 2, t + 1], left, right)
    assert torch.equal(l1, left * 2) and torch.equal(r2, right + 1)


def test_head_dtype_is_at_least_f32():
    assert tl.head_dtype(torch.bfloat16) == torch.float32
    assert tl.head_dtype(torch.float64) == torch.float64


def test_compute_weight_cache_follows_version():
    p = torch.nn.Parameter(torch.ones(3))
    with torch.no_grad():
        a = tl.compute_weight(p, torch.bfloat16)
        assert tl.compute_weight(p, torch.bfloat16) is a
        p.add_(1.0)
        b = tl.compute_weight(p, torch.bfloat16)
    assert b is not a and torch.equal(b.float(), torch.full((3,), 2.0))
