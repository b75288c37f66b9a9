"""Port CoEx vs the flax CoExNet of the JAX package, eval, f32, on the CPU.

A small model (48×80 input, max_disp 16; every width as the config's) with
numpy-drawn flax variables; the weights go JAX → port through
`coex_state_dict_from_jax`. At this size the nearest resizes fire: FeatUp's
first deconv gives 4×6 against a 3×5 skip, and the 3D up path 2×4×6
against 1×3×5 (D/4 = 4 goes to 2, 1, 1 and back). The flax forward is
jitted once per module and captures every submodule's output, which the
FeatUp test feeds to the port's. Tolerances: the whole model atol 1e-3 px
(the earlier slices'); modules rtol 1e-4, atol 1e-5 (`tests/test_layer_parity.py`),
or 1e-5 times the largest output where random weights grow the activations
(`tests/test_torch_gwcnet.py`). On the CPU the K1 and K2 wrappers run their
plain versions, so "kernels on" checks their wiring.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from openstereo_tpu.models.coex import CoExNet as FlaxCoExNet
from openstereo_tpu.models.igev import blocks as jblocks
from openstereo_tpu.ops import cost_volume as jcv
from openstereo_tpu.utils.torch_convert import convert_coex

from openstereo_tpu_torch import ops
from openstereo_tpu_torch.config import load_config
from openstereo_tpu_torch.models import build_model, set_kernels
from openstereo_tpu_torch.models.coex import CoExNet
from openstereo_tpu_torch.models.coex.coex import FeatUp, cosine_normalize
from openstereo_tpu_torch.models.igev.blocks import Conv2x, FeatureAtt
from openstereo_tpu_torch.utils import jax_weights as jw

from test_torch_gwcnet import close_to_scale, to_ncdhw
from test_torch_layers import TOL, _random_variables
from test_torch_ops import to_nchw, to_nhwc
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
CFG = ROOT / "cfgs/coex/coex_sceneflow_amp.yaml"
H, W, MAX_DISP = 48, 80, 16


@pytest.fixture(scope="module")
def reference():
    """(flax variables, NHWC inputs, flax disparity, captured module outputs):
    the module's one JAX compile."""
    rng = np.random.RandomState(0)
    data = {k: rng.randn(1, H, W, 3).astype(np.float32) for k in ("left", "right")}
    model = FlaxCoExNet(max_disp=MAX_DISP)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    variables = _random_variables(model, jdata, 21)
    out, state = jax.jit(lambda v, b: model.apply(v, b, train=False, capture_intermediates=True,
                                                  mutable=["intermediates"]))(variables, jdata)
    return variables, data, np.asarray(out["disp_pred"]), state["intermediates"]


def _port(variables, kernels=True):
    m = CoExNet(max_disp=MAX_DISP)
    m.load_state_dict(jw.coex_state_dict_from_jax(variables))
    return set_kernels(m.eval(), kernels)


def _run(model, data):
    with torch.inference_mode():
        return model({k: to_nchw(v) for k, v in data.items()})["disp_pred"].numpy()


@pytest.mark.parametrize("kernels", [True, False])
def test_coex_matches_flax(reference, kernels):
    variables, data, ref, _ = reference
    got = _run(_port(variables, kernels), data)
    assert got.shape == ref.shape == (1, H, W)
    print(f"CoEx port (kernels={kernels}) vs flax: max-abs {np.abs(got - ref).max():.3g} px, "
          f"disparity range {ref.min():.2f}..{ref.max():.2f}")
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


def test_kernel_path_matches_eager_path(reference):
    variables, data, _, _ = reference
    wired, eager = _run(_port(variables, True), data), _run(_port(variables, False), data)
    print(f"CoEx kernel path vs eager path (CPU): max-abs {np.abs(wired - eager).max():.3g} px")
    np.testing.assert_allclose(wired, eager, rtol=0, atol=1e-4)


def test_featup_matches_flax(reference):
    """The port's FeatUp on the flax trunk's captured taps (the siamese 2B
    batch; its first deconv's output is resized down to the 1/16 skip)."""
    variables, _, _, inter = reference
    b = jw.FlaxToTorch({"params": variables["params"]["up"],
                        "batch_stats": variables["batch_stats"]["up"]})
    for name in ("deconv32_16", "deconv16_8", "deconv8_4"):
        jw.conv2x(b, name, name)
    jw.basic_conv(b, "conv4", "conv4")
    port = FeatUp()
    port.load_state_dict(b.finish())
    taps = inter["trunk"]["__call__"][0][1:]
    with torch.inference_mode():
        got = port.eval()([to_nchw(t) for t in taps])
    ref = inter["up"]["__call__"][0]
    for i, (g, r) in enumerate(zip(got, ref)):
        close_to_scale(to_nhwc(g), r, f"FeatUp output {i}")


def _variables(module, inputs, seed):
    """flax variables of a module whose `__call__` takes several inputs,
    every leaf drawn from numpy as `_random_variables` draws them."""
    shapes = jax.eval_shape(lambda *a: module.init(jax.random.key(0), *a),
                            *map(jnp.asarray, inputs))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = str(path[-1])
        if "kernel" in name:
            a = rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif "scale" in name or "var" in name:
            a = rng.rand(*s.shape) + 0.5
        else:
            a = rng.randn(*s.shape) * 0.1
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize("x_hw,rem_hw", [((2, 3), (3, 5)), ((1, 2), (3, 5)), ((3, 5), (6, 10))],
                         ids=["deconv resized down", "deconv resized up", "no resize"])
def test_conv2x_matches_flax(x_hw, rem_hw):
    """Conv2x (deconv, BatchNorm), flax un-jitted, with the nearest resize of
    the deconv's output to the skip's size where the two differ."""
    rng = np.random.RandomState(sum(x_hw + rem_hw))
    x = rng.randn(2, *x_hw, 12).astype(np.float32)
    rem = rng.randn(2, *rem_hw, 8).astype(np.float32)
    fm = jblocks.Conv2x(8, deconv=True, norm="batch")
    v = _variables(fm, (x, rem), 3)
    b = jw.FlaxToTorch(v)
    jw.conv2x(b, "", "")
    tm = Conv2x(12, 8)
    tm.load_state_dict(b.finish())
    with torch.inference_mode():
        got = tm.eval()(to_nchw(x), to_nchw(rem))
    ref = np.asarray(fm.apply(v, jnp.asarray(x), jnp.asarray(rem), train=False))
    assert got.shape == (2, 16, *rem_hw)
    print(f"Conv2x {x_hw} -> {rem_hw}: max-abs {np.abs(to_nhwc(got) - ref).max():.3g}")
    np.testing.assert_allclose(to_nhwc(got), ref, **TOL)


def test_feature_att_matches_flax():
    """FeatureAtt: the sigmoid gate from a 1×1 BasicConvBN and a 1×1 conv with
    bias, broadcast over D of a [B,D,H,W,Cv] volume (flax un-jitted)."""
    rng = np.random.RandomState(4)
    cv = rng.randn(2, 3, 5, 7, 8).astype(np.float32)
    feat = rng.randn(2, 5, 7, 24).astype(np.float32)
    fm = jblocks.FeatureAtt(8)
    v = _variables(fm, (cv, feat), 5)
    b = jw.FlaxToTorch(v)
    jw.feature_att(b, "", "im_att")
    tm = FeatureAtt(8, 24)
    tm.load_state_dict(b.finish())
    with torch.inference_mode():
        got = tm.eval()(to_ncdhw(cv), to_nchw(feat))
    ref = np.asarray(fm.apply(v, jnp.asarray(cv), jnp.asarray(feat), train=False))
    print(f"FeatureAtt: max-abs {np.abs(to_nhwc(got) - ref).max():.3g}")
    np.testing.assert_allclose(to_nhwc(got), ref, **TOL)


def test_cosine_volume_matches_jax():
    """The descriptors divided by their norm and K1's mean product over 48
    channels × 48 (`coex.py:110-113`), the JAX side written as the model
    writes it; kernels on the CPU run the plain volume."""
    rng = np.random.RandomState(6)
    x, y = (rng.randn(1, 6, 40, 48).astype(np.float32) for _ in range(2))
    xj, yj = (a / (jnp.linalg.norm(a, axis=-1, keepdims=True) + 1e-12)
              for a in map(jnp.asarray, (x, y)))
    ref = np.asarray(jcv.correlation_volume(xj, yj, 12) * 48)
    xt, yt = cosine_normalize(to_nchw(x)), cosine_normalize(to_nchw(y))
    np.testing.assert_allclose(to_nhwc(xt), np.asarray(xj), **TOL)
    got = ops.corr_volume(xt, yt, 12) * 48
    print(f"cosine volume: max-abs {np.abs(to_nhwc(got) - ref).max():.3g}")
    np.testing.assert_allclose(to_nhwc(got), ref, **TOL)


def test_topk_regression_takes_lower_index_on_ties():
    """Planted ties between the 1st/2nd and the 2nd/3rd values, and a flat
    column: the port's top-k picks the lower index first, as `jax.lax.top_k`
    does, and the regression equals `coex.py:176-178`."""
    rng = np.random.RandomState(7)
    cost = rng.randn(2, 5, 6, 12).astype(np.float32)           # [B,H,W,D]
    cost[0, 0, 0, [3, 9]] = 10.0                                # a tie for the top
    cost[0, 0, 1, 4], cost[0, 0, 1, [2, 7, 11]] = 10.0, 5.0     # a tie for the 2nd
    cost[0, 1, 2] = 1.0                                         # all equal
    cost[1, 2, 3, [8, 1]] = 3.0, 3.0
    cost[1] = np.round(cost[1] * 2) / 2                         # many ties
    topv, topi = jax.lax.top_k(jnp.asarray(cost), 2)
    prob = jax.nn.softmax(topv, axis=-1)
    ref = np.asarray(jnp.sum(prob * topi.astype(jnp.float32), axis=-1))
    got = ops.topk_disparity_regression(to_nchw(cost), 2)
    assert tuple(np.asarray(topi[0, 0, 0])) == (3, 9) and tuple(np.asarray(topi[0, 0, 1])) == (4, 2)
    assert tuple(np.asarray(topi[0, 1, 2])) == (0, 1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape,size", [
    ((2, 4, 6, 3), (8, 12)), ((2, 5, 7, 3), (3, 4)), ((1, 3, 5, 2), (7, 9)),
    ((1, 2, 4, 6, 3), (1, 3, 5)), ((1, 1, 3, 5, 2), (2, 6, 10)), ((1, 2, 3, 5, 1), (4, 3, 5)),
])
def test_resize_nearest_matches_jax(shape, size):
    """`resize_nearest` vs `jax.image.resize(..., "nearest")` on 4-D and 5-D
    NHWC / NDHWC arrays, up, down, mixed and odd ratios: equal."""
    x = np.random.RandomState(len(shape) + sum(size)).randn(*shape).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (shape[0], *size, shape[-1]), "nearest"))
    got = ops.resize_nearest(to_nchw(x), size)
    np.testing.assert_array_equal(to_nhwc(got), ref)


def test_coex_state_dict_round_trip_is_exact(reference):
    """port state_dict → the JAX package's converter → the flax variables."""
    variables = reference[0]
    back = convert_coex({k: v.numpy() for k, v in _port(variables).state_dict().items()})
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])  # noqa: E731
    a, b = flat(back), flat(variables)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=str(k))


def test_build_model_reads_the_coex_config():
    cfg = load_config(str(CFG))
    model = build_model(cfg.MODEL, device="cpu", seed=0)
    assert isinstance(model, CoExNet) and not model.training
    assert (model.max_disp, model.topk) == (192, 2)
    assert model.CostProcessor.cost_volume.desc.weight.shape == (48, 48, 1, 1)
    agg = model.CostProcessor.cost_agg
    assert agg.conv_down[2][0].conv.weight.shape == (48, 32, 3, 3, 3)
    assert agg.conv_down[2][0].conv.stride == (2, 2, 2)
    assert model.DispProcessor.spx[0].weight.shape == (64, 9, 4, 4)
    ref = convert_coex({k: v.numpy() for k, v in model.state_dict().items()})
    assert set(ref["params"]) >= {"trunk", "up", "stem_2a", "cv_desc", "att_stem", "up0", "spx"}


def test_load_pretrained_skips_reference_only_modules(tmp_path):
    """A reference checkpoint also holds modules the reference never runs
    (`REFERENCE_ONLY_KEYS`); they are left out and the rest loads."""
    from openstereo_tpu_torch.tools.infer import load_pretrained

    src = _tiny_model(seed=1)
    state = dict(src.state_dict())
    state["CostProcessor.cost_agg.conv_skip.0.conv.weight"] = torch.zeros(8, 16, 1, 1, 1)
    state["Backbone.feat.up.conv4.bn.running_mean"] = torch.zeros(48)
    torch.save({"model_state": state}, tmp_path / "coex.pth")
    dst = _tiny_model(seed=2)
    assert load_pretrained(dst, str(tmp_path / "coex.pth")) == len(src.state_dict())
    assert all(torch.equal(v, dst.state_dict()[k]) for k, v in src.state_dict().items())


def _tiny_model(seed):
    cfg = load_config(str(CFG))
    cfg.MODEL["MAX_DISP"] = MAX_DISP
    return build_model(cfg.MODEL, device="cpu", seed=seed)


def test_infer_cli_on_cpu_with_the_coex_config(tmp_path):
    """The CoEx config's transforms and MODEL section, cut to max_disp 16 and
    a 48×80 pad so that the CPU run stays short."""
    from PIL import Image

    from openstereo_tpu_torch.tools import infer

    cfg = yaml.safe_load(CFG.read_text())
    cfg["MODEL"]["MAX_DISP"] = MAX_DISP
    cfg["DATA_CONFIG"]["DATA_TRANSFORM"]["EVALUATING"][0]["SIZE"] = [H, W]
    (tmp_path / "coex.yaml").write_text(yaml.safe_dump(cfg))
    img = (np.random.RandomState(15).rand(45, 76, 3) * 255).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "left.png")
    Image.fromarray(np.roll(img, -3, axis=1)).save(tmp_path / "right.png")
    out = tmp_path / "disp.png"
    disp = infer.main(["--cfg_file", str(tmp_path / "coex.yaml"),
                       "--left_img_path", str(tmp_path / "left.png"),
                       "--right_img_path", str(tmp_path / "right.png"),
                       "--out", str(out), "--device", "cpu"])
    assert disp.shape == (H, W) and np.isfinite(disp).all()
    assert 0 <= disp.min() and disp.max() <= MAX_DISP
    png = np.asarray(Image.open(out))
    assert png.shape == (H, W) and png.dtype == np.uint16


def test_bf16_coex_lies_as_far_from_f32_as_flax_does():
    """The whole CoEx in bf16 at the config's full width (max_disp 192), one
    128×256 random-dot pair, the port's seed-0 weights in both models
    (`coex_bf16_witness.py`). With random weights the costs are nearly flat,
    so bf16 rounding moves the top-2 picks and either model's bf16 disparity
    lies px away from its f32 one. Held: the head's input, port vs flax in
    bf16, within 2^-7·max|cost| on average (the card's rule between two bf16
    paths); where the top-2 picks of port and flax agree around a pixel,
    their bf16 disparities within 0.02 px on average (0.006 px here; a head
    run in bf16 gives 0.04); the port's bf16 distance from f32 within 15 % of
    flax's, its share of changed top-2 picks within 20 % of flax's, and its
    share of exact 2nd/3rd ties in bf16 within 0.03 of flax's; in f32, 99 %
    of the pixels within 1e-3 px (torch's sum order changes with its thread
    count, and at one thread a near-tie of the 2nd and 3rd costs flips,
    ~0.5 % of the pixels, up to 2.3 px)."""
    from coex_bf16_witness import CFG as FULL_CFG, compare, models, pairs

    ports, flax, variables = models(load_config(str(FULL_CFG)).MODEL)
    r = compare(ports, flax, variables, *next(pairs(1, (128, 256))))
    print(r)
    assert r["port_vs_flax_within_1e-3_f32"] >= 0.99
    assert r["head_input_port_vs_flax"]["bf16"] <= 2 ** -7
    assert r["agree_share_bf16"] >= 0.1 and r["agree_port_vs_flax_px_bf16"] <= 0.02
    dist, changed = r["bf16_to_f32_px"], r["topk_changed"]
    assert abs(dist["port"] - dist["flax"]) <= 0.15 * dist["flax"]
    assert abs(changed["port"] - changed["flax"]) <= 0.2 * changed["flax"]
    ties = {m: r["head_input"][f"{m} bf16"]["tie"] for m in ("port", "flax")}
    assert abs(ties["port"] - ties["flax"]) <= 0.03
