"""Port StereoBase vs the flax StereoBase of the JAX package, eval, f32, on the CPU.

Two small models with numpy-drawn flax variables of the training graph, in
the tree that `convert_stereobase` makes of the port's state_dict (the
reference's `.block` key spelling); the weights go JAX → port through
`stereobase_state_dict_from_jax`:
- the config's volume (gwc 8 groups + concat 8 a side) at 64×128, max_disp
  32, eval_iters 3, every other width as the config's (hidden 128, 3 GRU
  layers without slow-fast updates);
- every volume at once (gwc, concat, sub, interlaced with 4 channels) at
  32×64, where the channel order of the fused volume and the interlaced
  compressor's heads show.
Each flax forward is jitted once (`run_jitted_fast`, 3D convs in the
"native" lowering, ROADMAP 3d) and captures the descriptors and the
interlaced volume, which the module test reads.

Tolerances: the sub volume exact on integer-valued features (any sum order
is exact there) and rtol 1e-6 on random ones; modules rtol 1e-4, atol 1e-5
of the largest output (`close_to_scale`); the whole model 1e-3 px. On the
CPU the K2 and K3 wrappers run their plain versions, so "kernels on" checks
their wiring.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from openstereo_tpu.models.stereobase import stereobase as jsb
from openstereo_tpu.ops import cost_volume as jcv
from openstereo_tpu.utils.torch_convert import convert_stereobase

from openstereo_tpu_torch import ops
from openstereo_tpu_torch.config import Config
from openstereo_tpu_torch.models import build_model, set_kernels
from openstereo_tpu_torch.models.stereobase import StereoBase
from openstereo_tpu_torch.utils import jax_weights as jw

from test_torch_gwcnet import close_to_scale
from test_torch_igev_rt import run_config_on_the_cpu
from test_torch_layers import _random_variables_via, run_jitted_fast
from test_torch_ops import to_nchw
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
CFGS = sorted((ROOT / "cfgs/stereobase").glob("*.yaml"))
CASES = {
    "gwc+concat": (dict(max_disp=32, use_concat_volume=True, concat_channels=8, eval_iters=3),
                   (64, 128)),
    "all four": (dict(max_disp=32, use_concat_volume=True, concat_channels=8,
                      use_sub_volume=True, use_interlaced_volume=True, interlaced_channels=4,
                      eval_iters=3), (32, 64)),
}
CAPTURED = ("desc", "build_interlaced_volume")


def nhwc(t):
    return np.moveaxis(np.asarray(t), 1, -1)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """(name, kwargs, flax variables, NHWC normalised images, flax disparity,
    captured outputs, the port model): one JAX compile of the whole model a
    case."""
    kw, (h, w) = CASES[request.param]
    rng = np.random.RandomState(1)
    data = {k: (rng.rand(1, h, w, 3) * 2 - 1).astype(np.float32) for k in ("left", "right")}
    variables = _random_variables_via(convert_stereobase, StereoBase(**kw), 42)
    model = jsb.StereoBase(**kw)
    with pytest.MonkeyPatch.context() as mp:
        for var in ("OPENSTEREO_CONV3D", "OPENSTEREO_DECONV3D"):
            mp.setenv(var, "native")
        out, state = run_jitted_fast(lambda v, b: model.apply(
            v, b, train=False, capture_intermediates=lambda m, _: m.name in CAPTURED,
            mutable=["intermediates"]), variables, {k: jnp.asarray(v) for k, v in data.items()})
    port = StereoBase(**kw)
    port.load_state_dict(jw.stereobase_state_dict_from_jax(variables))
    return (request.param, kw, variables, data, np.asarray(out["disp_pred"]),
            state["intermediates"], port.eval())


@pytest.mark.parametrize("kernels", [True, False])
def test_stereobase_matches_flax(case, kernels):
    name, _, _, data, ref, _, port = case
    with torch.inference_mode():
        got = set_kernels(port, kernels)({k: to_nchw(v) for k, v in data.items()})[
            "disp_pred"].numpy()
    set_kernels(port, True)
    assert got.shape == ref.shape
    print(f"StereoBase {name} port (kernels={kernels}) vs flax: max-abs "
          f"{np.abs(got - ref).max():.3g} px, disparity range {ref.min():.2f}..{ref.max():.2f}")
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


def test_stereobase_state_dict_round_trip_is_exact(case):
    """port state_dict → the JAX package's converter → the flax variables
    (with the concat and, in "all four", the interlaced heads)."""
    name, kw, variables, _, _, _, port = case
    sd = port.state_dict()
    assert any(k.startswith("concat_conv.0.block.") for k in sd)
    assert any(k.startswith("build_interlaced_volume.") for k in sd) == (name == "all four")
    back = convert_stereobase({k: v.numpy() for k, v in sd.items()})
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])  # noqa: E731
    a, b = flat(back), flat(variables)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=str(k))


@pytest.mark.parametrize("case", ["all four"], indirect=True)
def test_interlaced_volume_matches_flax(case):
    """The compressor on flax's own descriptors: [B,F,D,H,W], the columns out
    of frame zero."""
    _, kw, _, _, _, inter, port = case
    left, right = (np.asarray(a) for a in inter["desc"]["__call__"])
    ref = np.asarray(inter["build_interlaced_volume"]["__call__"][0])  # [B,D,H,W,F]
    d4 = kw["max_disp"] // 4
    with torch.inference_mode():
        got = port.build_interlaced_volume(to_nchw(left), to_nchw(right), d4)
    assert got.shape == (1, 4, d4, *left.shape[1:3])
    close_to_scale(np.moveaxis(got.numpy(), 1, -1), ref, "InterlacedVolume")
    for d in range(1, d4):
        assert not got[:, :, d, :, :d].any()


@pytest.mark.parametrize("integer", [True, False])
def test_sub_volume_matches_jax(integer):
    """`build_sub_volume` against the JAX builder (`ops/cost_volume.py:135`):
    out of frame (w < d, and planes with d >= W) the L1 norm of the left
    features alone. Integer-valued features make every sum exact, so the two
    are bit-equal there; on random features the two sum orders agree to
    rtol 1e-6."""
    rng = np.random.RandomState(2)
    b, c, h, w, d = 2, 96, 5, 9, 12
    draw = (lambda: rng.randint(-8, 9, (b, h, w, c))) if integer else (
        lambda: rng.randn(b, h, w, c))
    left, right = (draw().astype(np.float32) for _ in range(2))
    ref = np.asarray(jcv.build_sub_volume(jnp.asarray(left), jnp.asarray(right), d))
    got = ops.build_sub_volume(to_nchw(left), to_nchw(right), d)
    assert got.shape == (b, d, h, w) and ref.shape == (b, h, w, d)
    got = got.permute(0, 2, 3, 1).numpy()
    l1 = np.abs(left).sum(-1)
    assert np.allclose(got[:, :, 3, 7], l1[:, :, 3], rtol=1e-6)  # out of frame: |left|
    assert np.allclose(got[:, :, :, 10], l1, rtol=1e-6)  # d >= W
    if integer:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", ["StereoBase", "StereoBaseGRU"])
def test_build_model_takes_both_names(name):
    """The JAX registry takes both (`stereobase.py:101-102`); the configs name
    StereoBaseGRU."""
    cfg = Config.from_dict({"NAME": name, "MAX_DISP": 32, "USE_CONCAT_VOLUME": True,
                            "CONCAT_CHANNELS": 8, "EVAL_ITERS": 1})
    model = build_model(cfg, device="cpu", seed=0)
    assert isinstance(model, StereoBase) and model.volume_channels == 24
    assert model.eval_iters == 1


@pytest.mark.parametrize("cfg_file", CFGS, ids=lambda p: p.stem)
def test_build_model_runs_each_config_on_the_cpu_through_the_plain_kernels(cfg_file,
                                                                            monkeypatch):
    cfg, model = run_config_on_the_cpu(cfg_file, StereoBase, monkeypatch, "eval_iters")
    assert cfg.MODEL.NAME == "StereoBaseGRU"
    assert (model.max_disp, model.volume_channels, model.hidden_dims, model.slow_fast_gru) == (
        192, 24, (128, 128, 128), False)
