"""Port IGEV++ vs the flax IGEVPP of the JAX package, eval, f32, on the CPU.

A small model (64×128 input, max_disp 128, ranges 16/16/32 at intervals
1/2/4, valid_iters 3; every width as the config's: hidden dims 128, 3 GRU
layers, 2 correlation levels, radius 4) with numpy-drawn flax variables of
the training graph, in the tree that `convert_igevpp` makes of the port's
state_dict; the weights go JAX → port through `igevpp_state_dict_from_jax`.
The flax forward is jitted once (`run_jitted_fast`, 3D convs in the
"native" lowering, ROADMAP 3d) and captures the features, the stems, the
medium range's pooled volume and its hourglass, which the hourglass test
reads. The 3D InstanceNorm block and the InstanceNorm feature attention run
un-jitted on their own; the update block and its encoders are applied on
their own with the model's variables.

Tolerances: modules rtol 1e-4, atol 1e-5 of the largest output
(`close_to_scale`); the whole model 1e-3 px. On the CPU the K2 and K3
wrappers run their plain versions, so "kernels on" checks their wiring.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from openstereo_tpu.models.igev import blocks as jblocks
from openstereo_tpu.models.igevpp import igevpp as jpp
from openstereo_tpu.utils.torch_convert import convert_igevpp

from openstereo_tpu_torch.models import set_kernels
from openstereo_tpu_torch.models.igev.blocks import BasicConvIN, FeatureAtt
from openstereo_tpu_torch.models.igevpp import IGEVPP
from openstereo_tpu_torch.utils import jax_weights as jw

from test_torch_gwcnet import close_to_scale
from test_torch_igev_rt import run_config_on_the_cpu
from test_torch_layers import _random_like, _random_variables_via, run_jitted_fast
from test_torch_ops import to_nchw
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
CFGS = sorted((ROOT / "cfgs/igevpp").glob("*.yaml"))
H, W = 64, 128
TINY = dict(max_disp=128, s_disp_range=16, s_disp_interval=1, m_disp_range=16,
            m_disp_interval=2, l_disp_range=32, l_disp_interval=4, valid_iters=3)
CAPTURED = ("feature", "stem_4b", "patch0", "cost_agg1")


def nhwc(t):
    return np.moveaxis(np.asarray(t), 1, -1)


def ncdhw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


@pytest.fixture(scope="module")
def reference():
    """(flax variables, NHWC images in [0,255], flax disparity, captured
    outputs): the module's one JAX compile of the whole model."""
    rng = np.random.RandomState(0)
    data = {k: (rng.rand(1, H, W, 3) * 255).astype(np.float32) for k in ("left", "right")}
    variables = _random_variables_via(convert_igevpp, IGEVPP(**TINY), 43)
    model = jpp.IGEVPP(**TINY)
    with pytest.MonkeyPatch.context() as mp:
        for var in ("OPENSTEREO_CONV3D", "OPENSTEREO_DECONV3D"):
            mp.setenv(var, "native")
        out, state = run_jitted_fast(lambda v, b: model.apply(
            v, b, train=False, capture_intermediates=lambda m, _: m.name in CAPTURED,
            mutable=["intermediates"]), variables, {k: jnp.asarray(v) for k, v in data.items()})
    return variables, data, np.asarray(out["disp_pred"]), state["intermediates"]


@pytest.fixture(scope="module")
def port(reference):
    model = IGEVPP(**TINY)
    model.load_state_dict(jw.igevpp_state_dict_from_jax(reference[0]))
    return model.eval()


def captured(inter, name):
    return inter[name]["__call__"][0]


def _module_variables(module, args, seed):
    shapes = jax.eval_shape(lambda *a: module.init(jax.random.key(0), *a), *args)
    return _random_like(shapes, seed)


# ----------------------------------------------------------------------- blocks

@pytest.mark.parametrize("k,s,deconv", [(3, 1, False), (3, 2, False), (1, 1, False),
                                        (4, 2, True)])
def test_basic_conv_in_3d_matches_flax(k, s, deconv):
    """conv (or the k4 s2 deconv) + InstanceNorm over D, H, W + leaky_relu."""
    x = jnp.asarray(np.random.RandomState(10 + k + s).randn(2, 6, 8, 10, 5).astype(np.float32))
    fm = jblocks.BasicConvIN(7, k, s, deconv=deconv, ndim=3)
    v = _module_variables(fm, (x,), 11)
    b = jw.FlaxToTorch(v)
    jw.basic_conv(b, "", "", bn=False, deconv=deconv)
    tm = BasicConvIN(5, 7, k, s, deconv=deconv, ndim=3)
    tm.load_state_dict(b.finish())
    ref = fm.apply(v, x)
    with torch.inference_mode():
        got = tm.eval()(ncdhw(x))
    close_to_scale(np.moveaxis(got.numpy(), 1, -1), ref, f"BasicConvIN 3D k{k} s{s} "
                                                         f"deconv={deconv}")


def test_feature_att_instance_matches_flax():
    """The gate's first 1×1 conv with InstanceNorm (IGEV++'s flavour)."""
    rng = np.random.RandomState(12)
    cv = jnp.asarray(rng.randn(1, 4, 6, 10, 8).astype(np.float32))
    feat = jnp.asarray(rng.randn(1, 6, 10, 24).astype(np.float32))
    fm = jblocks.FeatureAtt(8, norm="instance")
    v = _module_variables(fm, (cv, feat), 13)
    b = jw.FlaxToTorch(v)
    jw.feature_att(b, "", "feat_att", bn=False)
    tm = FeatureAtt(8, 24, key="feat_att", norm="instance")
    tm.load_state_dict(b.finish())
    ref = fm.apply(v, cv, feat)
    with torch.inference_mode():
        got = tm.eval()(ncdhw(cv), to_nchw(np.asarray(feat)))
    close_to_scale(np.moveaxis(got.numpy(), 1, -1), ref, "FeatureAtt instance")


def test_pp_hourglass_matches_flax(reference, port):
    """cost_agg1 on flax's own pooled medium range and left features (the
    1/4 ones with the stem's 48 channels, read by the extra att4 stage)."""
    _, _, _, inter = reference
    feats = [np.asarray(f)[:1] for f in captured(inter, "feature")]
    feats[0] = np.concatenate([feats[0], np.asarray(captured(inter, "stem_4b"))[:1]], -1)
    with torch.inference_mode():
        got = port.cost_agg1(ncdhw(captured(inter, "patch0")), [to_nchw(f) for f in feats])
    close_to_scale(np.moveaxis(got.numpy(), 1, -1), captured(inter, "cost_agg1"), "PPHourglass")


# ----------------------------------------------------------------------- update block

def _update_inputs(seed):
    """net (1/4, 1/8, 1/16), context triples, the three ranges' taps, the
    correlation taps, the selective weights and disp; NHWC, hidden 128."""
    rng = np.random.RandomState(seed)
    sizes = [(8, 16), (4, 8), (2, 4)]
    net = [np.tanh(rng.randn(1, h, w, 128)).astype(np.float32) for h, w in sizes]
    inp = [tuple((rng.randn(1, h, w, 128) * 0.5).astype(np.float32) for _ in range(3))
           for h, w in sizes]
    geo = [rng.randn(1, 8, 16, c).astype(np.float32) for c in (144, 72, 72)]
    corr = rng.randn(1, 8, 16, 18).astype(np.float32)
    sel_w = (1.0 / (1.0 + np.exp(-rng.randn(1, 8, 16, 3)))).astype(np.float32)
    disp = rng.uniform(0, 8, (1, 8, 16, 1)).astype(np.float32)
    return net, inp, geo, corr, sel_w, disp


def test_geo_encoder_matches_flax(reference, port):
    params = reference[0]["params"]["gru_loop"]["update_block"]["geo_encoder0"]
    geo = _update_inputs(1)[2][0]
    ref = run_jitted_fast(lambda p, g: jpp.GeoEncoder().apply({"params": p}, g), params, geo)
    with torch.inference_mode():
        got = port.update_block.geo_encoder0(to_nchw(geo))
    close_to_scale(nhwc(got), ref, "GeoEncoder")


def test_basic_disp_encoder_matches_flax(reference, port):
    """96 fused geometry channels + 18 correlation taps, and the disparity → 128."""
    params = reference[0]["params"]["gru_loop"]["update_block"]["encoder"]
    rng = np.random.RandomState(2)
    geo = rng.randn(1, 8, 16, 114).astype(np.float32)
    disp = rng.uniform(0, 8, (1, 8, 16, 1)).astype(np.float32)
    ref = run_jitted_fast(lambda p, d, g: jpp.BasicDispEncoder().apply({"params": p}, d, g),
                          params, disp, geo)
    with torch.inference_mode():
        got = port.update_block.encoder(to_nchw(disp), to_nchw(geo))
    assert got.shape == (1, 128, 8, 16)
    close_to_scale(nhwc(got), ref, "BasicDispEncoder")


def test_pp_update_block_matches_flax(reference, port):
    """The three-scale cascade with the selective blend of the three ranges."""
    params = reference[0]["params"]["gru_loop"]["update_block"]
    net, inp, geo, corr, sel_w, disp = _update_inputs(3)
    block = jpp.PPUpdateBlock(hidden_dims=(128, 128, 128), n_gru_layers=3)
    ref = run_jitted_fast(lambda p, n, i, g, c, s, d: block.apply(
        {"params": p}, n, i, g[0], g[1], g[2], c, s, d), params, net, inp, geo, corr, sel_w, disp)
    with torch.inference_mode():
        got = port.update_block([to_nchw(n) for n in net],
                                [tuple(to_nchw(c) for c in t) for t in inp],
                                *(to_nchw(g) for g in geo), to_nchw(corr), to_nchw(sel_w),
                                to_nchw(disp))
    (gnet, gmask, gdelta), (rnet, rmask, rdelta) = got, ref
    assert gmask.shape == (1, 64, 8, 16)
    close_to_scale(nhwc(gmask), rmask, "PPUpdateBlock mask_feat_4")
    close_to_scale(nhwc(gdelta), rdelta, "PPUpdateBlock delta disparity")
    for i, (g, r) in enumerate(zip(gnet, rnet)):
        close_to_scale(nhwc(g), r, f"PPUpdateBlock net[{i}]")


# ----------------------------------------------------------------------- whole model

@pytest.mark.parametrize("kernels", [True, False])
def test_igevpp_matches_flax(reference, port, kernels):
    _, data, ref, _ = reference
    with torch.inference_mode():
        got = set_kernels(port, kernels)({k: to_nchw(v) for k, v in data.items()})[
            "disp_pred"].numpy()
    set_kernels(port, True)
    assert got.shape == ref.shape == (1, H, W)
    print(f"IGEV++ port (kernels={kernels}) vs flax: max-abs {np.abs(got - ref).max():.3g} px, "
          f"disparity range {ref.min():.2f}..{ref.max():.2f}")
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


def test_igevpp_state_dict_round_trip_is_exact(reference, port):
    """port state_dict → the JAX package's converter → the flax variables."""
    back = convert_igevpp({k: v.numpy() for k, v in port.state_dict().items()})
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])  # noqa: E731
    a, b = flat(back), flat(reference[0])
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=str(k))


@pytest.mark.parametrize("cfg_file", CFGS, ids=lambda p: p.stem)
def test_build_model_runs_each_config_on_the_cpu_through_the_plain_kernels(cfg_file,
                                                                            monkeypatch):
    """At full width: K3 once over the whole MAX_DISP/4 = 192 planes."""
    _, model = run_config_on_the_cpu(cfg_file, IGEVPP, monkeypatch, "valid_iters")
    assert (model.max_disp, model.ranges, model.hidden_dims) == (
        768, ((48, 1), (96, 2), (192, 4)), (128, 128, 128))
