"""Port FastFoundationStereo vs the flax FastFoundationStereo of the JAX package,
eval, f32, on the CPU.

A small model (64×96 input, max_disp 64, valid_iters 2; every width as the
config's: VIT_SIZE vitl's channel budget 224 at 1/4, hidden 128, one GRU
scale, volume 28, concat 24, 8 cosine groups, 2 correlation levels, radius
4) with numpy-drawn flax variables in the tree that
`convert_fastfoundationstereo` makes of the port's state_dict; the weights
go JAX → port through `fastfoundationstereo_state_dict_from_jax`. The flax
forward is jitted once (`run_jitted_fast`, 3D convs "native") and captures
the features, the gated volume, the AHCF hourglass (its disparity
transformer attends over the heads, `headwise`) and the context heads. The
one-scale update block (its motion encoder fusing with a 1×1 conv) runs on
its own with the model's variables. The modules FoundationStereo shares
are held in `tests/test_torch_foundationstereo.py`.

Tolerances as there: modules within 1e-5·max|ref|, the whole model 2e-4 px.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from openstereo_tpu.models.fastfoundationstereo import fastfoundationstereo as jffs
from openstereo_tpu.utils.torch_convert import convert_fastfoundationstereo

from openstereo_tpu_torch.config import load_config
from openstereo_tpu_torch.models import build_model, set_kernels
from openstereo_tpu_torch.models.fastfoundationstereo import FastFoundationStereo
from openstereo_tpu_torch.utils import jax_weights as jw

from test_torch_foundationstereo import captured, check_update_block, within_scale
from test_torch_igev_rt import counted_plain_kernels
from test_torch_layers import _random_variables_via, run_jitted_fast
from test_torch_ops import to_nchw, to_nhwc
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
CFG = ROOT / "cfgs/fast_foundationstereo/ffstereo_sceneflow.yaml"
H, W = 64, 96
TINY = dict(max_disp=64, valid_iters=2)
CAPTURED = ("feature", "corr_feature_att", "cost_agg", "cnet")


@pytest.fixture(scope="module")
def reference():
    """(flax variables, NHWC images, flax disparity, captured outputs): the
    module's one JAX compile."""
    rng = np.random.RandomState(1)
    data = {k: rng.randn(1, H, W, 3).astype(np.float32) for k in ("left", "right")}
    variables = _random_variables_via(convert_fastfoundationstereo, FastFoundationStereo(**TINY),
                                      44)
    model = jffs.FastFoundationStereo(**TINY)
    with pytest.MonkeyPatch.context() as mp:
        for var in ("OPENSTEREO_CONV3D", "OPENSTEREO_DECONV3D"):
            mp.setenv(var, "native")
        out, state = run_jitted_fast(lambda v, b: model.apply(
            v, b, train=False, capture_intermediates=lambda m, _: m.name in CAPTURED,
            mutable=["intermediates"]), variables, {k: jnp.asarray(v) for k, v in data.items()})
    return variables, data, np.asarray(out["disp_pred"]), state["intermediates"]


@pytest.fixture(scope="module")
def port(reference):
    model = FastFoundationStereo(**TINY)
    model.load_state_dict(jw.fastfoundationstereo_state_dict_from_jax(reference[0]))
    return model.eval()


def test_features_match_flax(reference, port):
    """The EdgeNeXt trunk, the Conv2x_IN decoder and the 1×1 widening to 224
    channels, both views."""
    _, data, _, inter = reference
    x = to_nchw(np.concatenate([data["left"], data["right"]], axis=0))
    with torch.inference_mode():
        got = port.feature(x, port.dtype)
    assert got[0].shape[1] == 224
    for i, (g, r) in enumerate(zip(got, captured(inter, "feature"))):
        within_scale(to_nhwc(g), r, f"features level {i}")


def test_headwise_ahcf_hourglass_matches_flax(reference, port):
    """On flax's own gated volume: the disparity transformer attends over the
    heads at each disparity (`headwise`)."""
    _, _, _, inter = reference
    assert port.cost_agg.atts["4"].sa[0].headwise
    feats = [to_nchw(np.asarray(f)[:1]) for f in captured(inter, "feature")]
    vol = torch.from_numpy(np.ascontiguousarray(np.moveaxis(
        np.asarray(captured(inter, "corr_feature_att")), -1, 1)))
    with torch.inference_mode():
        got = port.cost_agg(vol, feats)
    within_scale(np.moveaxis(got.numpy(), 1, -1), captured(inter, "cost_agg"),
                 "headwise AHCF hourglass")


def test_shared_context_net_matches_flax(reference, port):
    _, _, _, inter = reference
    x4 = to_nchw(np.asarray(captured(inter, "feature")[0])[:1])
    with torch.inference_mode():
        (net, inp), = port.cnet(x4)
    (ref_net, ref_inp), = captured(inter, "cnet")
    within_scale(to_nhwc(net), ref_net, "context net hidden")
    within_scale(to_nhwc(inp), ref_inp, "context net input")


def test_one_scale_update_block_matches_flax(reference, port):
    """gru04 alone, the motion encoder fusing with a 1×1 conv."""
    assert port.update_block.encoder.conv.kernel_size == (1, 1)
    check_update_block(reference[0], port.update_block, 1, 1, 8)


@pytest.mark.parametrize("kernels", [True, False])
def test_fastfoundationstereo_matches_flax(reference, port, kernels):
    _, data, ref, _ = reference
    with torch.inference_mode():
        got = set_kernels(port, kernels)({k: to_nchw(v) for k, v in data.items()})[
            "disp_pred"].numpy()
    set_kernels(port, True)
    assert got.shape == ref.shape == (1, H, W)
    print(f"FastFoundationStereo port (kernels={kernels}) vs flax: max-abs "
          f"{np.abs(got - ref).max():.3g} px, disparity range {ref.min():.2f}..{ref.max():.2f}")
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4)


def test_fastfoundationstereo_state_dict_round_trip_is_exact(reference, port):
    """port state_dict → the JAX package's converter → the flax variables."""
    back = convert_fastfoundationstereo({k: v.numpy() for k, v in port.state_dict().items()})
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])  # noqa: E731
    a, b = flat(back), flat(reference[0])
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=str(k))


def test_build_model_runs_the_config_on_the_cpu_through_the_plain_k3(monkeypatch):
    """The SceneFlow config at full width and depth (8 iterations) on a 64×128
    pair: a finite disparity, K3 once (its plain version) with divisor 1."""
    calls = counted_plain_kernels(monkeypatch)
    model = build_model(load_config(str(CFG)).MODEL, device="cpu", seed=0)
    assert isinstance(model, FastFoundationStereo) and not model.training
    assert (model.max_disp, model.valid_iters, model.n_gru_layers, model.corr_levels) == (
        192, 8, 1, 2)
    x = torch.rand(1, 3, 64, 128, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        disp = model({"left": x, "right": x.roll(-3, dims=-1)})["disp_pred"]
    assert disp.shape == (1, 64, 128) and torch.isfinite(disp).all()
    assert calls == {"gwc": 1, "mbconv": 0}
