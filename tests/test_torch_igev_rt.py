"""Port IGEV-RT vs the flax IGEVRT of the JAX package, eval, f32, on the CPU.

A small model (64×128 input, max_disp 32, valid_iters 3; every width as
the config's: hidden 96, 2 correlation levels, radius 4) with numpy-drawn
flax variables of the training graph, in the tree that `convert_igev_rt`
makes of the port's state_dict; the weights go JAX → port through
`igev_rt_state_dict_from_jax`. The flax forward is jitted once
(`run_jitted_fast`, 3D convs in the "native" lowering, ROADMAP 3d); the
update block and its motion encoder are applied on their own with the same
variables.

Tolerances: modules rtol 1e-4, atol 1e-5 of the largest output
(`close_to_scale`); the whole model 1e-3 px. On the CPU the K2 and K3
wrappers run their plain versions, so "kernels on" checks their wiring.
"""

import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from openstereo_tpu.models.igev_rt import igev_rt as jrt
from openstereo_tpu.utils.torch_convert import convert_igev_rt

from openstereo_tpu_torch.config import load_config
from openstereo_tpu_torch.models import build_model, set_kernels
from openstereo_tpu_torch.models.igev_rt import IGEVRT
from openstereo_tpu_torch.models.igevpp import IGEVPP
from openstereo_tpu_torch.utils import jax_weights as jw

import torch_train_step as ts
from test_torch_gwcnet import close_to_scale
from test_torch_layers import _random_variables_via, run_jitted_fast
from test_torch_ops import to_nchw
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
CFGS = sorted((ROOT / "cfgs/igev_rt").glob("*.yaml"))
H, W = 64, 128
TINY = dict(max_disp=32, valid_iters=3)
gwc_volume_mod = importlib.import_module("openstereo_tpu_torch.ops.gwc_volume")
fused_mbconv_mod = importlib.import_module("openstereo_tpu_torch.ops.fused_mbconv")


def nhwc(t):
    return np.moveaxis(np.asarray(t), 1, -1)


@pytest.fixture(scope="module")
def reference():
    """(flax variables, NHWC images in [0,255], flax disparity): the module's
    one JAX compile of the whole model."""
    rng = np.random.RandomState(0)
    data = {k: (rng.rand(1, H, W, 3) * 255).astype(np.float32) for k in ("left", "right")}
    variables = _random_variables_via(convert_igev_rt, IGEVRT(**TINY), 41)
    model = jrt.IGEVRT(**TINY)
    with pytest.MonkeyPatch.context() as mp:
        for var in ("OPENSTEREO_CONV3D", "OPENSTEREO_DECONV3D"):
            mp.setenv(var, "native")
        out = run_jitted_fast(lambda v, b: model.apply(v, b, train=False), variables,
                              {k: jnp.asarray(v) for k, v in data.items()})
    return variables, data, np.asarray(out["disp_pred"])


@pytest.fixture(scope="module")
def port(reference):
    model = IGEVRT(**TINY)
    model.load_state_dict(jw.igev_rt_state_dict_from_jax(reference[0]))
    return model.eval()


def _update_inputs(seed):
    """net and context triple (hidden 96), geometry taps (2·9·8), disp; NHWC."""
    rng = np.random.RandomState(seed)
    net = np.tanh(rng.randn(1, 8, 16, 96)).astype(np.float32)
    ctx = tuple((rng.randn(1, 8, 16, 96) * 0.5).astype(np.float32) for _ in range(3))
    geo = rng.randn(1, 8, 16, 144).astype(np.float32)
    disp = rng.uniform(0, 8, (1, 8, 16, 1)).astype(np.float32)
    return net, ctx, geo, disp


def test_rt_motion_encoder_matches_flax(reference, port):
    """95 conv channels, then the disparity: 96."""
    params = reference[0]["params"]["gru_loop"]["update_block"]["encoder"]
    _, _, geo, disp = _update_inputs(1)
    ref = run_jitted_fast(lambda p, d, g: jrt.RTMotionEncoder().apply({"params": p}, d, g),
                          params, disp, geo)
    with torch.inference_mode():
        got = port.update_block.encoder(to_nchw(disp), to_nchw(geo))
    assert got.shape == (1, 96, 8, 16)
    close_to_scale(nhwc(got), ref, "RTMotionEncoder")


def test_basic_update_block_matches_flax(reference, port):
    params = reference[0]["params"]["gru_loop"]["update_block"]
    net, ctx, geo, disp = _update_inputs(2)
    block = jrt.BasicUpdateBlock(96)
    ref = run_jitted_fast(lambda p, n, c, g, d: block.apply({"params": p}, n, c, g, d),
                          params, net, ctx, geo, disp)
    with torch.inference_mode():
        got = port.update_block(to_nchw(net), tuple(to_nchw(c) for c in ctx), to_nchw(geo),
                                to_nchw(disp))
    for what, g, r in zip(("net", "mask_feat_4", "delta disparity"), got, ref):
        close_to_scale(nhwc(g), r, f"BasicUpdateBlock {what}")


@pytest.mark.parametrize("kernels", [True, False])
def test_igev_rt_matches_flax(reference, port, kernels):
    _, data, ref = reference
    with torch.inference_mode():
        got = set_kernels(port, kernels)({k: to_nchw(v) for k, v in data.items()})[
            "disp_pred"].numpy()
    set_kernels(port, True)
    assert got.shape == ref.shape == (1, H, W)
    print(f"IGEV-RT port (kernels={kernels}) vs flax: max-abs {np.abs(got - ref).max():.3g} px, "
          f"disparity range {ref.min():.2f}..{ref.max():.2f}")
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


def test_igev_rt_state_dict_round_trip_is_exact(reference, port):
    """port state_dict → the JAX package's converter → the flax variables."""
    back = convert_igev_rt({k: v.numpy() for k, v in port.state_dict().items()})
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])  # noqa: E731
    a, b = flat(back), flat(reference[0])
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=str(k))


def counted_plain_kernels(monkeypatch):
    """Count the calls of the plain K3 and K2 (what the wrappers run on the CPU)."""
    calls = {"gwc": 0, "mbconv": 0}

    def counted(key, fn):
        def wrapper(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(gwc_volume_mod, "gwc_volume_plain",
                        counted("gwc", gwc_volume_mod.gwc_volume_plain))
    monkeypatch.setattr(fused_mbconv_mod, "mbconv_plain",
                        counted("mbconv", fused_mbconv_mod.mbconv_plain))
    return calls


def run_config_on_the_cpu(cfg_file, cls, monkeypatch, iters_attr, iters=2, hw=(64, 128)):
    """`build_model` on a config at full width on the CPU, its GRU loop cut to
    `iters` for time: a finite disparity, K3 once and K2 11 times (both views
    in one batch) through their plain versions; then a training forward: the
    initial disparity (IGEV++: three) and `iters` iterates at the images'
    size, through neither wrapper."""
    calls = counted_plain_kernels(monkeypatch)
    cfg = load_config(str(cfg_file))
    model = build_model(cfg.MODEL, device="cpu", seed=0)
    assert isinstance(model, cls) and not model.training
    setattr(model, iters_attr, iters)
    x = torch.rand(1, 3, *hw, generator=torch.Generator().manual_seed(0)) * 255
    with torch.inference_mode():
        disp = model({"left": x, "right": x.roll(-3, dims=-1)})["disp_pred"]
    assert disp.shape == (1, *hw) and torch.isfinite(disp).all()
    assert calls == {"gwc": 1, "mbconv": 11}
    model.train_iters = iters
    with torch.no_grad():
        ts.check_training_outputs(model, {"left": x, "right": x.roll(-3, dims=-1)},
                                  3 if isinstance(model, IGEVPP) else 1)
    assert calls == {"gwc": 1, "mbconv": 11}  # training runs the plain builders
    return cfg, model


@pytest.mark.parametrize("cfg_file", CFGS, ids=lambda p: p.stem)
def test_build_model_runs_each_config_on_the_cpu_through_the_plain_kernels(cfg_file,
                                                                            monkeypatch):
    _, model = run_config_on_the_cpu(cfg_file, IGEVRT, monkeypatch, "valid_iters")
    assert (model.max_disp, model.hidden_dim, model.valid_iters, model.corr_levels) == (
        192, 96, 2, 2)
