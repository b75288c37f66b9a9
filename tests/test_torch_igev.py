"""Port IGEV-Stereo vs the flax IGEV of the JAX package, eval, f32, on the CPU.

A small model (64×128 input, max_disp 32, valid_iters 3; every width as
the config's: hidden dims 128, 3 GRU layers with slow-fast updates, 2
correlation levels, radius 4) with numpy-drawn flax variables of the
training graph, in the tree that `convert_igev` makes of the port's
state_dict; the weights go JAX → port through `igev_state_dict_from_jax`.
The flax forward is jitted once (`run_jitted_fast`, 3D convs in the
"native" lowering, ROADMAP 3d) and captures the features, the context
net, the volume after its feature attention and the hourglass, which the
module tests read. The GRU modules are applied on their own with the same
variables.

Tolerances: the lookups rtol 1e-5 (atol 1e-6 of the volume's scale);
modules rtol 1e-4, atol 1e-5 of the largest output (`close_to_scale`); the
whole model 1e-3 px. On the CPU the K2 and K3 wrappers run their plain
versions, so "kernels on" checks their wiring.
"""

import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from openstereo_tpu.models.igev import IGEV as FlaxIGEV
from openstereo_tpu.models.igev import blocks as jblocks
from openstereo_tpu.models.igev import geometry as jgeo
from openstereo_tpu.models.igev import update as jupdate
from openstereo_tpu.utils.torch_convert import convert_igev

from openstereo_tpu_torch.config import load_config
from openstereo_tpu_torch.models import build_model, set_kernels
from openstereo_tpu_torch.models.igev import IGEV
from openstereo_tpu_torch.models.igev import geometry as tgeo
from openstereo_tpu_torch.utils import jax_weights as jw

from openstereo_tpu_torch.models.igev.blocks import Conv2x

import torch_train_step as ts
from test_torch_gwcnet import close_to_scale
from test_torch_layers import _random_like, _random_variables_via, run_jitted_fast
from test_torch_ops import to_nchw
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
CFG = ROOT / "cfgs/igev/igev_sceneflow_amp.yaml"
H, W = 64, 128
TINY = dict(max_disp=32, valid_iters=3)
CAPTURED = ("feature", "cnet", "cost_agg", "corr_feature_att")
# the wrappers' modules (`openstereo_tpu_torch.ops` exports functions of the same names)
gwc_volume_mod = importlib.import_module("openstereo_tpu_torch.ops.gwc_volume")
fused_mbconv_mod = importlib.import_module("openstereo_tpu_torch.ops.fused_mbconv")


def nhwc(t):
    return np.moveaxis(np.asarray(t), 1, -1)


@pytest.fixture(scope="module")
def reference():
    """(flax variables, NHWC images in [0,255], flax disparity, captured
    outputs): the module's one JAX compile of the whole model."""
    rng = np.random.RandomState(0)
    data = {k: (rng.rand(1, H, W, 3) * 255).astype(np.float32) for k in ("left", "right")}
    variables = _random_variables_via(convert_igev, IGEV(**TINY), 40)
    model = FlaxIGEV(**TINY)
    with pytest.MonkeyPatch.context() as mp:
        for var in ("OPENSTEREO_CONV3D", "OPENSTEREO_DECONV3D"):
            mp.setenv(var, "native")
        out, state = run_jitted_fast(lambda v, b: model.apply(
            v, b, train=False, capture_intermediates=lambda m, _: m.name in CAPTURED,
            mutable=["intermediates"]), variables, {k: jnp.asarray(v) for k, v in data.items()})
    return variables, data, np.asarray(out["disp_pred"]), state["intermediates"]


@pytest.fixture(scope="module")
def port(reference):
    model = IGEV(**TINY)
    model.load_state_dict(jw.igev_state_dict_from_jax(reference[0]))
    return model.eval()


def captured(inter, name):
    return inter[name]["__call__"][0]


def images(data):
    return [2.0 * (to_nchw(data[k]) / 255.0) - 1.0 for k in ("left", "right")]


# ----------------------------------------------------------------------- lookups

def _volume_and_positions(length, t=9, seed=0):
    """A [2,3,4,5,length] volume and [2,3,4,t] positions covering every case:
    out of range on both sides, in (-1, 0) and (L-1, L), exactly on 0, L-1
    and inner integers, and fractional."""
    rng = np.random.RandomState(seed)
    vol = rng.randn(2, 3, 4, 5, length).astype(np.float32)
    special = np.array([-3.0, -1.0, -0.75, -0.25, 0.0, 0.5, length - 1.0, length - 0.6,
                        length - 0.2, length, length + 2.5, 1.0, 2.25], np.float32)
    pos = rng.uniform(-2.0, length + 1.0, (2, 3, 4, t)).astype(np.float32)
    flat = pos.reshape(-1)
    flat[: special.size] = special
    return vol, flat.reshape(pos.shape)


def test_lookup_1d_matches_jax():
    vol, pos = _volume_and_positions(12)
    ref = np.asarray(jgeo.lookup_1d(jnp.asarray(vol), jnp.asarray(pos)))
    got = tgeo.lookup_1d(torch.from_numpy(vol), torch.from_numpy(pos)).numpy()
    assert got.shape == ref.shape == (2, 3, 4, 5 * 9)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_multi_lookup_matches_jax_with_zero_padding_per_level():
    """Two levels (12 and 6 long): positions at each level's edges must not
    read the other level's values."""
    (v0, p0), (v1, p1) = _volume_and_positions(12, seed=1), _volume_and_positions(6, seed=2)
    v1 = v1[..., :6]
    ref = jgeo.MultiLookup([jnp.asarray(v0), jnp.asarray(v1)])(
        [jnp.asarray(p0), jnp.asarray(p1)])
    got = tgeo.MultiLookup([torch.from_numpy(v0), torch.from_numpy(v1)])(
        [torch.from_numpy(p0), torch.from_numpy(p1)])
    for lvl, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6,
                                   err_msg=f"level {lvl}")
    # level 1 alone, in its own frame: the same up to the rounding of its
    # positions offset by level 0's 12 (as JAX's merged lookup rounds them)
    alone = tgeo.lookup_1d(torch.from_numpy(v1), torch.from_numpy(p1))
    np.testing.assert_allclose(got[1].numpy(), alone.numpy(), rtol=1e-5, atol=1e-5)


def test_combined_geo_encoding_volume_matches_jax():
    """[B,8,D,H,W] geometry volume, [B,C,H,W] descriptors, two levels, radius
    4, disparities that put taps outside both pyramids' frames."""
    rng = np.random.RandomState(3)
    b, c, d, h, w = 1, 16, 12, 3, 20
    ml, mr = (rng.randn(b, h, w, c).astype(np.float32) for _ in range(2))
    geo = rng.randn(b, d, h, w, 8).astype(np.float32)
    disp = rng.uniform(-1.5, d + 1.5, (b, h, w)).astype(np.float32)
    disp.reshape(-1)[:6] = [0.0, 0.3, d - 1.0, d - 0.4, -0.7, 2.0]
    coords = np.broadcast_to(np.arange(w, dtype=np.float32), (b, h, w)).copy()
    ref = jgeo.CombinedGeoEncodingVolume(jnp.asarray(ml), jnp.asarray(mr), jnp.asarray(geo))(
        jnp.asarray(disp), jnp.asarray(coords))
    got = tgeo.CombinedGeoEncodingVolume(to_nchw(ml), to_nchw(mr),
                                         torch.from_numpy(geo).permute(0, 4, 1, 2, 3))(
        torch.from_numpy(disp), torch.from_numpy(coords))
    assert got.shape == ref.shape == (b, h, w, 2 * 9 * 9)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6 * float(np.abs(ref).max()))


# ----------------------------------------------------------------------- modules

def test_feature_matches_flax(reference, port):
    """The siamese 2B batch through `Feature` (64×128: no resize fires)."""
    _, data, _, inter = reference
    with torch.inference_mode():
        got = port.feature(torch.cat(images(data)))
    for i, (g, r) in enumerate(zip(got, captured(inter, "feature"))):
        close_to_scale(nhwc(g), r, f"Feature output {i}")


def test_feature_with_mismatched_conv2x_resizes_matches_flax(reference, port):
    """40×72: the trunk gives 1/32 2×3 and 1/16 3×5, so deconv32_16's 4×6 and
    deconv16_8's 6×10 are nearest-resized (half-pixel) to 3×5 and 5×9."""
    variables = reference[0]
    x = np.random.RandomState(5).randn(1, 40, 72, 3).astype(np.float32)
    sub = {c: variables[c]["feature"] for c in ("params", "batch_stats")}
    ref = run_jitted_fast(lambda v, a: jblocks.Feature().apply(v, a, train=False), sub,
                          jnp.asarray(x))
    with torch.inference_mode():
        got = port.feature(to_nchw(x))
    assert [tuple(g.shape[2:]) for g in got] == [(10, 18), (5, 9), (3, 5), (2, 3)]
    for i, (g, r) in enumerate(zip(got, ref)):
        close_to_scale(nhwc(g), r, f"Feature 40x72 output {i}")


@pytest.mark.parametrize("deconv,concat,norm,keep_concat", [
    (True, True, "instance", False), (False, True, "batch", True), (True, False, "none", True)])
def test_conv2x_variants_match_flax(deconv, concat, norm, keep_concat):
    """The Conv2x variants beyond the decoder's (a k3 s2 conv, the sum in place
    of the concatenation, keep_concat off, no norm), each with a skip one
    smaller than conv1's output on both axes: the half-pixel nearest resize."""
    rng = np.random.RandomState(10)
    x = rng.randn(2, 5, 7, 12).astype(np.float32)
    rem = rng.randn(2, 9 if deconv else 2, 13 if deconv else 3, 8).astype(np.float32)
    fm = jblocks.Conv2x(8, deconv=deconv, concat=concat, norm=norm, keep_concat=keep_concat)
    v = _random_like(jax.eval_shape(lambda a, r: fm.init(jax.random.key(0), a, r),
                                    jnp.asarray(x), jnp.asarray(rem)), 11)
    b = jw.FlaxToTorch(v)
    for i, deconv_i in ((1, deconv), (2, False)):
        jw.basic_conv(b, f"conv{i}", f"conv{i}", bn=norm == "batch", deconv=deconv_i)
    tm = Conv2x(12, 8, deconv=deconv, concat=concat, norm=norm, keep_concat=keep_concat)
    tm.load_state_dict(b.finish())
    ref = fm.apply(v, jnp.asarray(x), jnp.asarray(rem))
    with torch.inference_mode():
        got = tm.eval()(to_nchw(x), to_nchw(rem))
    close_to_scale(nhwc(got), ref, f"Conv2x deconv={deconv} concat={concat} norm={norm}")


def test_multi_basic_encoder_matches_flax(reference, port):
    _, data, _, inter = reference
    with torch.inference_mode():
        got = port.cnet(images(data)[0])
    for scale, (gs, rs) in enumerate(zip(got, captured(inter, "cnet"))):
        for i, (g, r) in enumerate(zip(gs, rs)):
            close_to_scale(nhwc(g), r, f"MultiBasicEncoder scale {scale} output {i}")


def test_geo_hourglass_matches_flax(reference, port):
    """The hourglass on flax's own gated volume and left features."""
    _, _, _, inter = reference
    x = captured(inter, "corr_feature_att")
    feats = [np.asarray(f)[:1] for f in captured(inter, "feature")]
    feats[0] = None  # the 1/4 features are not read by the hourglass
    with torch.inference_mode():
        got = port.cost_agg(torch.from_numpy(np.array(np.moveaxis(x, -1, 1))),
                            [None if f is None else to_nchw(f) for f in feats])
    close_to_scale(np.moveaxis(got.numpy(), 1, -1), captured(inter, "cost_agg"), "GeoHourglass")


def _gru_inputs(seed):
    """net (1/4, 1/8, 1/16), context triples and lookups, NHWC, hidden 128."""
    rng = np.random.RandomState(seed)
    sizes = [(8, 16), (4, 8), (2, 4)]
    net = [np.tanh(rng.randn(1, h, w, 128)).astype(np.float32) for h, w in sizes]
    inp = [tuple((rng.randn(1, h, w, 128) * 0.5).astype(np.float32) for _ in range(3))
           for h, w in sizes]
    geo = rng.randn(1, 8, 16, 162).astype(np.float32)
    disp = rng.uniform(0, 8, (1, 8, 16, 1)).astype(np.float32)
    return net, inp, geo, disp


def test_conv_gru_matches_flax(reference, port):
    """gru08 with two inputs and its context biases."""
    params = reference[0]["params"]["gru_loop"]["update_block"]["gru08"]
    net, inp, _, _ = _gru_inputs(6)
    x1 = np.random.RandomState(7).randn(1, 4, 8, 128).astype(np.float32)
    x2 = np.random.RandomState(8).randn(1, 4, 8, 128).astype(np.float32)
    gru = jupdate.ConvGRU(128)
    ref = run_jitted_fast(lambda p, h, c, a, b: gru.apply({"params": p}, h, c, a, b),
                          params, net[1], inp[1], x1, x2)
    with torch.inference_mode():
        got = port.update_block.gru08(to_nchw(net[1]), tuple(to_nchw(c) for c in inp[1]),
                                      to_nchw(x1), to_nchw(x2))
    close_to_scale(nhwc(got), ref, "ConvGRU")


@pytest.mark.parametrize("flags", [
    dict(iter16=True, iter08=False, iter04=False, update=False),
    dict(iter16=True, iter08=True, iter04=False, update=False),
    dict(iter16=True, iter08=True, iter04=True, update=True)])
def test_basic_multi_update_block_matches_flax(reference, port, flags):
    """The three calls of one slow-fast iteration."""
    params = reference[0]["params"]["gru_loop"]["update_block"]
    net, inp, geo, disp = _gru_inputs(9)
    block = jupdate.BasicMultiUpdateBlock(hidden_dims=(128, 128, 128), n_gru_layers=3)
    ref = run_jitted_fast(lambda p, n, i, g, d: block.apply({"params": p}, n, i, g, d, **flags),
                          params, net, inp, geo, disp)
    with torch.inference_mode():
        got = port.update_block([to_nchw(n) for n in net],
                                [tuple(to_nchw(c) for c in t) for t in inp],
                                to_nchw(geo), to_nchw(disp), **flags)
    if flags["update"]:
        (got, mask, delta), (ref, rmask, rdelta) = got, ref
        close_to_scale(nhwc(mask), rmask, "mask_feat_4")
        close_to_scale(nhwc(delta), rdelta, "delta disparity")
    for i, (g, r) in enumerate(zip(got, ref)):
        close_to_scale(nhwc(g), r, f"net[{i}] after {flags}")


# ----------------------------------------------------------------------- whole model

@pytest.mark.parametrize("kernels", [True, False])
def test_igev_matches_flax(reference, port, kernels):
    _, data, ref, _ = reference
    with torch.inference_mode():
        got = set_kernels(port, kernels)({k: to_nchw(v) for k, v in data.items()})[
            "disp_pred"].numpy()
    set_kernels(port, True)
    assert got.shape == ref.shape == (1, H, W)
    print(f"IGEV port (kernels={kernels}) vs flax: max-abs {np.abs(got - ref).max():.3g} px, "
          f"disparity range {ref.min():.2f}..{ref.max():.2f}")
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


def test_igev_state_dict_round_trip_is_exact(reference, port):
    """port state_dict → the JAX package's converter → the flax variables."""
    back = convert_igev({k: v.numpy() for k, v in port.state_dict().items()})
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])  # noqa: E731
    a, b = flat(back), flat(reference[0])
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=str(k))


def test_build_model_runs_the_config_on_the_cpu_through_the_plain_kernels(monkeypatch):
    """The config's IGEV at full width on the CPU: the K3 and K2 wrappers run
    their plain versions (once per frame and 11 times, both views in one
    batch); the GRU loop cut to 2 iterations for time. A training forward
    gives the initial disparity and TRAIN_ITERS iterates (cut to 2) at the
    images' size, through neither wrapper."""
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
    cfg = load_config(str(CFG))
    model = build_model(cfg.MODEL, device="cpu", seed=0)
    assert isinstance(model, IGEV) and not model.training
    assert (model.max_disp, model.hidden_dims, model.valid_iters, model.corr_levels) == (
        192, (128, 128, 128), 32, 2)
    model.valid_iters = 2
    x = torch.rand(1, 3, 64, 128, generator=torch.Generator().manual_seed(0)) * 255
    with torch.inference_mode():
        disp = model({"left": x, "right": x.roll(-3, dims=-1)})["disp_pred"]
    assert disp.shape == (1, 64, 128) and torch.isfinite(disp).all()
    assert calls == {"gwc": 1, "mbconv": 11}
    model.train_iters = 2
    with torch.no_grad():
        ts.check_training_outputs(model, {"left": x, "right": x.roll(-3, dims=-1)})
    assert calls == {"gwc": 1, "mbconv": 11}  # training runs the plain builders
