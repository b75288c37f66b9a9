"""Port CasGwcNet (and, through `model_tests`, CasPSMNet in
`tests/test_torch_caspsmnet.py`) vs the flax models of the JAX package,
eval, f32, on the CPU, and the cascade's shared pieces.

Small models (64×128 input, max_disp 32, ndisps (16, 8), intervals (2, 1),
the neighbourhood search on, the config's widths) with numpy-drawn flax
variables of the training graph, in the tree that `convert_casnet` makes
of the port's state_dict; the weights go JAX → port through
`casnet_state_dict_from_jax`. Each flax forward is jitted once
(`run_jitted_fast`) and captures the features and each stage's
aggregation, which the module tests read.

Tolerances. Modules as `tests/test_torch_gwcnet.py` (rtol 1e-4, atol 1e-5
of the largest output), among them stage 1's cost before its softmax. The
sample-grid logic is held at 1e-5 px. The disparities are ill-conditioned
in f32 under random weights: the features reach ~2e3 after 25 residual
blocks, CasGwcNet's warped group-wise costs ~1e6, and its soft-argmax is
nearly one-hot, so where the two best samples nearly tie, the ~1e-7
relative differences of two f32 sum orders in the cost move the prediction
(stage 1 by up to ~0.03 px at 5 of 8192 pixels here, and stage 2's
neighbourhood search carries that into the ranges around them). The
disparities, of each stage and of the whole model, are therefore held at
1e-3 px at all but 2 % of the pixels (CasGwcNet reads ~1 %, CasPSMNet 0),
at 1e-4 px on average, and at 0.05 px everywhere. No kernel of the port
lies on these paths; "kernels on" is checked all the same.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from openstereo_tpu.models.casnet import CasGwcNet as FlaxCasGwcNet
from openstereo_tpu.models.casnet import CasPSMNet as FlaxCasPSMNet
from openstereo_tpu.models.casnet import casnet as jcas
from openstereo_tpu.ops.upsample import resize_linear_torch
from openstereo_tpu.utils.torch_convert import convert_casnet

from openstereo_tpu_torch.config import load_config
from openstereo_tpu_torch.models import build_model, set_kernels
from openstereo_tpu_torch.models.casnet import CasGwcNet, CasPSMNet
from openstereo_tpu_torch.models.casnet import casnet as tcas
from openstereo_tpu_torch.ops import resize_linear
from openstereo_tpu_torch.utils import jax_weights as jw

from test_torch_gwcnet import close_to_scale
from test_torch_layers import _random_variables_via, run_jitted_fast
from test_torch_ops import to_nchw
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
CFGS = {"CasGwcNet": ROOT / "cfgs/casnet/casnet_gwc_sceneflow.yaml",
        "CasPSMNet": ROOT / "cfgs/casnet/casnet_psm_sceneflow.yaml"}
H, W = 64, 128
TINY = dict(max_disp=32, ndisps=(16, 8), disp_interval_pixel=(2.0, 1.0))
FLAX = {"CasGwcNet": FlaxCasGwcNet, "CasPSMNet": FlaxCasPSMNet}
PORT = {"CasGwcNet": CasGwcNet, "CasPSMNet": CasPSMNet}
NAMES = ["CasGwcNet"]  # CasPSMNet: tests/test_torch_caspsmnet.py, as this file's cases
NEAR_TIE_SHARE = 0.02

def _reference(name, seed):
    rng = np.random.RandomState(seed)
    data = {k: rng.randn(1, H, W, 3).astype(np.float32) for k in ("left", "right")}
    variables = _random_variables_via(convert_casnet, PORT[name](**TINY), seed + 40)
    model = FLAX[name](**TINY)
    out, state = run_jitted_fast(lambda v, b: model.apply(
        v, b, train=False, capture_intermediates=lambda m, _: m.name in ("features", "cost_agg0",
                                                                          "classif3b"),
        mutable=["intermediates"]), variables, {k: jnp.asarray(v) for k, v in data.items()})
    return variables, data, np.asarray(out["disp_pred"]), state["intermediates"]


def model_references(name, seed):
    """{name: (flax variables, NHWC inputs, flax disparity, captured
    outputs)}: one JAX compile, its 3D convs in the "native" lowering that
    the port follows (ROADMAP 3d)."""
    with pytest.MonkeyPatch.context() as mp:
        for var in ("OPENSTEREO_CONV3D", "OPENSTEREO_DECONV3D"):
            mp.setenv(var, "native")
        return {name: _reference(name, seed)}


def model_ports(references):
    """name → {"model": the port model, kernels on/off: its disparity,
    "stage1": its stage-1 prediction}."""
    out = {}
    for name, (variables, data, _, _) in references.items():
        model = PORT[name](**TINY)
        model.load_state_dict(jw.casnet_state_dict_from_jax(variables))
        model.eval()
        rec = {"model": model}
        hook = model.cost_agg[0].register_forward_hook(
            lambda mod, i, o: rec.__setitem__("stage1", o.numpy()))
        for k in (True, False):
            with torch.inference_mode():
                rec[k] = set_kernels(model, k)({n: to_nchw(v) for n, v in data.items()})[
                    "disp_pred"].numpy()
        hook.remove()
        out[name] = rec
    return out


@pytest.fixture(scope="module")
def references():
    return model_references("CasGwcNet", 0)


@pytest.fixture(scope="module")
def ports(references):
    return model_ports(references)


def assert_disparity_close(got, ref, what):
    """1e-3 px at all but NEAR_TIE_SHARE of the pixels, 1e-4 px on average,
    0.05 px everywhere (the module docstring says why)."""
    err = np.abs(got - ref)
    share = float((err > 1e-3).mean())
    print(f"{what}: max-abs {err.max():.3g} px, mean-abs {err.mean():.3g} px, {share:.3g} of "
          f"the pixels beyond 1e-3 px (cap {NEAR_TIE_SHARE}), disparity range "
          f"{ref.min():.2f}..{ref.max():.2f}")
    assert share <= NEAR_TIE_SHARE and err.mean() <= 1e-4
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-2)


@pytest.mark.parametrize("using_ns", [True, False])
def test_disp_range_samples_match_jax(using_ns):
    cur = (np.random.RandomState(2).rand(2, H, W) * 40 - 4).astype(np.float32)  # negatives too
    first = np.asarray(jcas.disp_range_samples(None, 48, 4.0, (2, H, W), 192.0, using_ns, 3))
    np.testing.assert_array_equal(
        tcas.disp_range_samples(None, 48, 4.0, (2, H, W), 192.0, using_ns, 3).numpy(), first)
    ref = np.asarray(jax.jit(lambda p: jcas.disp_range_samples(
        p, 24, 1.0, (2, H, W), 192.0, using_ns, 3))(cur))
    got = tcas.disp_range_samples(torch.from_numpy(cur), 24, 1.0, (2, H, W), 192.0, using_ns, 3)
    assert got.shape == (2, 24, H, W)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_max_pool_same_matches_jax():
    x = np.random.RandomState(3).randn(2, 9, 13).astype(np.float32)
    np.testing.assert_array_equal(tcas.max_pool_same(torch.from_numpy(x), 3).numpy(),
                                  np.asarray(jcas.max_pool_same(jnp.asarray(x), 3)))


def _samples(h, w, d, seed):
    """Per-pixel samples over [-2, W+1] with some falling on integers."""
    s = np.random.RandomState(seed).rand(1, d, h, w) * (w + 3) - 2
    s[:, 0] = np.round(s[:, 0])
    return s.astype(np.float32)


@pytest.mark.parametrize("zero_left", [False, True])
def test_warped_concat_volume_matches_jax(zero_left):
    rng = np.random.RandomState(4)
    x, y = (rng.randn(1, 5, 17, 6).astype(np.float32) for _ in range(2))
    s = _samples(5, 17, 4, 5)
    ref = np.asarray(jax.jit(jcas.build_warped_concat_volume, static_argnums=3)(
        x, y, s, zero_left))
    got = tcas.build_warped_concat_volume(to_nchw(x), to_nchw(y), torch.from_numpy(s), zero_left)
    assert got.shape == (1, 12, 4, 5, 17)
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), ref, rtol=0, atol=1e-6)


def test_warped_gwc_volume_matches_jax():
    rng = np.random.RandomState(6)
    x, y = (rng.randn(1, 5, 17, 16).astype(np.float32) for _ in range(2))
    s = _samples(5, 17, 4, 7)
    ref = np.asarray(jax.jit(jcas.build_warped_gwc_volume, static_argnums=3)(x, y, s, 4))
    got = tcas.build_warped_gwc_volume(to_nchw(x), to_nchw(y), torch.from_numpy(s), 4)
    assert got.shape == (1, 4, 4, 5, 17)
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), ref, rtol=0, atol=1e-6)


def test_resize_linear_shrinks_sample_grids_as_jax():
    """Stage 1's samples at full resolution, shrunk to 1/4 in D, H and W."""
    s = np.asarray(jcas.disp_range_samples(None, 48, 4.0, (1, 96, 128), 192.0, True, 3))
    ref = np.asarray(jax.jit(lambda a: resize_linear_torch(a / 4, (12, 24, 32),
                                                           axes=(1, 2, 3)))(s))
    got = resize_linear(torch.from_numpy(s / 4)[:, None], (12, 24, 32))[:, 0]
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def model_tests(names):
    """The whole-model tests, parametrized over the cascade `names`, as test
    functions for a test module to hold (this one's CasGwcNet,
    `tests/test_torch_caspsmnet.py`'s CasPSMNet: one JAX compile per file)."""

    @pytest.mark.parametrize("kernels", [True, False])
    @pytest.mark.parametrize("name", names)
    def test_casnet_matches_flax(references, ports, name, kernels):
        ref, got = references[name][2], ports[name][kernels]
        assert got.shape == ref.shape == (1, H, W)
        assert_disparity_close(got, ref, f"{name} port (kernels={kernels}) vs flax")

    @pytest.mark.parametrize("name", names)
    def test_stage_one_and_its_sample_grids_match_flax(references, ports, name):
        """Stage 1's prediction, and the stage-2 sample grids that the port and
        `disp_range_samples` make of flax's stage-1 prediction (neighbourhood
        search, |min-pool|, trilinear resizes), at 1e-5 px."""
        inter = references[name][3]
        ref1 = np.asarray(inter["cost_agg0"]["__call__"][0][0])
        assert_disparity_close(ports[name]["stage1"], ref1, f"{name} stage 1")
        ref = np.asarray(jax.jit(lambda p: jcas.disp_range_samples(
            p, 8, 1.0, (1, H, W), 32.0, True, 3))(ref1))
        got = tcas.disp_range_samples(torch.from_numpy(ref1), 8, 1.0, (1, H, W), 32.0, True, 3)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)

    @pytest.mark.parametrize("name", names)
    def test_cascade_features_match_flax(references, ports, name):
        """The siamese 2B batch through the port's PSM/Gwc cascade features."""
        _, data, _, inter = references[name]
        x = np.concatenate([data["left"], data["right"]])
        with torch.inference_mode():
            got = ports[name]["model"].feature_extraction(to_nchw(x))
        ref = inter["features"]["__call__"][0]
        flat = (lambda t: [a for p in t for a in p]) if name == "CasGwcNet" else list
        for i, (g, r) in enumerate(zip(flat(got), flat(ref))):
            close_to_scale(np.moveaxis(g.numpy(), 1, -1), r, f"{name} features {i}")

    @pytest.mark.parametrize("name", names)
    def test_cost_aggregation_matches_flax(references, ports, name):
        """Stage 1's CasCostAggregation (GwcHourglass ×3, the classifier, the
        trilinear resize to (D, H, W), the soft-argmax against the samples) on
        the volume that the JAX builders make of flax's captured features."""
        _, _, _, inter = references[name]
        feats = inter["features"]["__call__"][0][0]
        samples = jcas.disp_range_samples(None, 16, 2.0, (1, H, W), 32.0, True, 3)

        def volume(feats, samples):
            samples_s = resize_linear_torch(samples / 4, (4, H // 4, W // 4), axes=(1, 2, 3))
            if name == "CasPSMNet":
                return jcas.build_warped_concat_volume(feats[:1], feats[1:], samples_s)
            g, c = feats
            return jnp.concatenate([
                jcas.build_warped_gwc_volume(g[:1], g[1:], samples_s, 40),
                jcas.build_warped_concat_volume(c[:1], c[1:], samples_s, zero_left=True)], -1)

        vol = np.asarray(jax.jit(volume)(feats, samples))
        agg = ports[name]["model"].cost_agg[0]
        with torch.inference_mode():
            cost = agg.cost(to_nchw(vol).contiguous())
            got = agg(to_nchw(vol).contiguous(), (16, H, W), torch.from_numpy(np.asarray(samples)))
        close_to_scale(np.moveaxis(cost.numpy(), 1, -1), inter["cost_agg0"]["classif3b"]["__call__"][0],
                       f"{name} stage-1 cost")
        assert_disparity_close(got.numpy(), np.asarray(inter["cost_agg0"]["__call__"][0][0]),
                               f"{name} CasCostAggregation stage 1")

    @pytest.mark.parametrize("name", names)
    def test_casnet_state_dict_round_trip_is_exact(references, ports, name):
        """port state_dict → the JAX package's converter → the flax variables."""
        variables = references[name][0]
        back = convert_casnet({k: v.numpy() for k, v in ports[name]["model"].state_dict().items()})
        flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])  # noqa: E731
        a, b = flat(back), flat(variables)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=str(k))

    @pytest.mark.parametrize("name", names)
    def test_build_model_reads_the_casnet_configs(name):
        cfg = load_config(str(CFGS[name]))
        model = build_model(cfg.MODEL, device="cpu", seed=0)
        assert isinstance(model, PORT[name]) and not model.training
        assert (model.ndisps, model.disp_interval_pixel, model.using_ns, model.ns_size) == (
            (48, 24), (4.0, 1.0), True, 3)
        assert [a.dres0[0][0].weight.shape[:2] for a in model.cost_agg] == [(32, 64), (32, 32)]

    @pytest.mark.parametrize("name", names)
    def test_infer_cli_on_cpu_with_the_casnet_configs(tmp_path, name):
        """The config's transforms and MODEL section, cut to the test's ndisps
        and a 64×128 pad so that the CPU run stays short."""
        from PIL import Image

        from openstereo_tpu_torch.tools import infer

        cfg = yaml.safe_load(CFGS[name].read_text())
        cfg["MODEL"].update({k.upper(): list(v) if isinstance(v, tuple) else v
                             for k, v in TINY.items()})
        cfg["DATA_CONFIG"]["DATA_TRANSFORM"]["EVALUATING"][0]["SIZE"] = [H, W]
        (tmp_path / "cas.yaml").write_text(yaml.safe_dump(cfg))
        img = (np.random.RandomState(15).rand(60, 120, 3) * 255).astype(np.uint8)
        Image.fromarray(img).save(tmp_path / "left.png")
        Image.fromarray(np.roll(img, -3, axis=1)).save(tmp_path / "right.png")
        out = tmp_path / "disp.png"
        disp = infer.main(["--cfg_file", str(tmp_path / "cas.yaml"),
                           "--left_img_path", str(tmp_path / "left.png"),
                           "--right_img_path", str(tmp_path / "right.png"),
                           "--out", str(out), "--device", "cpu"])
        assert disp.shape == (H, W) and np.isfinite(disp).all()
        assert 0 <= disp.min() and disp.max() <= TINY["max_disp"]
        png = np.asarray(Image.open(out))
        assert png.shape == (H, W) and png.dtype == np.uint16

    return {f.__name__: f for f in (
        test_casnet_matches_flax, test_stage_one_and_its_sample_grids_match_flax,
        test_cascade_features_match_flax, test_cost_aggregation_matches_flax,
        test_casnet_state_dict_round_trip_is_exact, test_build_model_reads_the_casnet_configs,
        test_infer_cli_on_cpu_with_the_casnet_configs)}


globals().update(model_tests(NAMES))
