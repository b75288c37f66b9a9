"""Port samplers and the half-pixel linear resize vs the JAX package, on the CPU.

`ops.sample_along_w` against `openstereo_tpu/ops/sampler.py:sample_along_w`,
`ops.bilinear_sampler` against `bilinear_sampler` (its packed-patch form),
and `ops.resize_linear` against `openstereo_tpu/ops/upsample.py:
resize_linear_torch`, each on the same numpy-drawn inputs, with positions
inside, on the edges of and outside the frame (the `y0f == -1` slot of
`_sample_packed` included). f32: the gathers are exact and the weights the
same, so only the last sum may differ (atol 1e-6 at values ~1); the
resize's per-axis matrix products and `F.interpolate` sum in other orders
(atol 1e-5). The JAX functions are jitted here: one compile in place of
an op-by-op dispatch of each primitive, and in f32 the same values. The
bf16 forms, op by op, are in `tests/test_torch_bf16_parity.py`.
"""

import numpy as np
import pytest
import torch

import jax

from openstereo_tpu.ops import sampler as jsampler
from openstereo_tpu.ops import upsample as jup

from openstereo_tpu_torch import ops

from test_torch_ops import to_nchw
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)


def edge_positions(rng, shape, w):
    """Sample positions over [-2, W+1] with the frame's edges planted: -1,
    -0.5, 0, W-1, W-0.5 and W at the first entries."""
    pos = (rng.rand(*shape) * (w + 3) - 2).astype(np.float32)
    flat = pos.reshape(-1)
    flat[:6] = [-1.0, -0.5, 0.0, w - 1.0, w - 0.5, float(w)]
    return pos


@pytest.mark.parametrize("b,h,w,c,d", [(2, 5, 7, 6, 3), (1, 3, 40, 16, 12)])
def test_sample_along_w_matches_jax(b, h, w, c, d):
    rng = np.random.RandomState(w)
    y = rng.randn(b, h, w, c).astype(np.float32)
    pos = edge_positions(rng, (b, d, h, w), w)
    ref = np.asarray(jax.jit(jsampler.sample_along_w)(y, pos))
    got = ops.sample_along_w(to_nchw(y), torch.from_numpy(pos))
    assert got.shape == (b, c, d, h, w)
    got = np.moveaxis(got.numpy(), 1, -1)
    out = (pos < -1) | (pos > w)
    assert not got[out].any(), "a position wholly outside the frame sampled a nonzero value"
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("b,h,w,c", [(2, 5, 7, 6), (1, 9, 16, 3)])
def test_bilinear_sampler_matches_jax(b, h, w, c):
    rng = np.random.RandomState(h)
    img = rng.randn(b, h, w, c).astype(np.float32)
    coords = np.stack([rng.rand(b, 4, 6) * (w + 3) - 2, rng.rand(b, 4, 6) * (h + 3) - 2],
                      axis=-1).astype(np.float32)
    # the corners and edges: (-1,-1), [-1,0) on both axes (the y0f == -1 slot
    # rule), the last pixel, half past it, and wholly outside
    coords[0, 0, :6] = [[-1, -1], [-0.5, -0.25], [0, 0], [w - 1, h - 1], [w - 0.5, h - 0.5],
                        [w + 0.5, 2]]
    ref = np.asarray(jax.jit(jsampler.bilinear_sampler)(img, coords))
    got = ops.bilinear_sampler(to_nchw(img), torch.from_numpy(coords))
    assert got.shape == (b, c, 4, 6)
    got = np.moveaxis(got.numpy(), 1, -1)
    assert not got[0, 0, 0].any() and not got[0, 0, 5].any()
    np.testing.assert_allclose(got[0, 0, 2], img[0, 0, 0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("size", [(3, 4, 8), (12, 16, 32), (48, 64, 128), (5, 9, 40), (1, 1, 1)])
def test_resize_linear_matches_resize_linear_torch(size):
    """Trilinear, half-pixel, no antialiasing, shrinking and growing (CasNet
    shrinks its full-resolution sample grids and grows its costs)."""
    x = np.random.RandomState(3).randn(2, 12, 16, 32).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a: jup.resize_linear_torch(a, size, axes=(1, 2, 3)))(x))
    got = ops.resize_linear(torch.from_numpy(x)[:, None], size)[:, 0].numpy()
    assert got.shape == ref.shape == (2,) + size
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("size", [(4, 8), (36, 50)])
def test_resize_linear_bilinear_matches_resize_linear_torch(size):
    x = np.random.RandomState(4).randn(3, 16, 32).astype(np.float32)
    ref = np.asarray(jax.jit(lambda a: jup.resize_linear_torch(a, size, axes=(1, 2)))(x))
    got = ops.resize_linear(torch.from_numpy(x)[:, None], size)[:, 0].numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
