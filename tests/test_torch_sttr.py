"""Port STTR vs the flax STTR of the JAX package, eval, f32, on the CPU.

Flax variables are drawn with numpy from a seed and carried to the port
with `openstereo_tpu_torch.utils.jax_weights`; both sides run the same
input. The flax model runs its einsum attention (the CPU has no Pallas), so
"kernels on" here checks the port's K4 wiring through the wrapper's plain
version and "kernels off" the port's eager path. Modules are held at rtol
1e-4, atol 1e-5 (`tests/test_layer_parity.py`), the attention at the 1e-4
of `tests/test_rel_attention.py`, and the tiny whole model at 1e-3 px, the
tolerance of the LightStereo slice. The whole-model flax forward is computed
once per module (the `tiny` fixture).
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from openstereo_tpu import ops as jops
from openstereo_tpu.models.sttr import blocks as jb
from openstereo_tpu.models.sttr import sttr as js
from openstereo_tpu.models.sttr import transformer as jt
from openstereo_tpu.utils.torch_convert import convert_sttr

from openstereo_tpu_torch import ops
from openstereo_tpu_torch.config import load_config
from openstereo_tpu_torch.models import build_model, set_kernels
from openstereo_tpu_torch.models.sttr import STTR
from openstereo_tpu_torch.models.sttr import blocks as tb
from openstereo_tpu_torch.models.sttr import sttr as ts
from openstereo_tpu_torch.models.sttr import transformer as tt
from openstereo_tpu_torch.utils import jax_weights as jw

from test_torch_ops import to_nchw, to_nhwc
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
CFG = ROOT / "cfgs/sttr/sttr_flyingthings3d.yaml"
TOL = dict(rtol=1e-4, atol=1e-5)
H, W = 48, 96
TINY = dict(channel_dim=32, nheads=4, num_attn_layers=2, cal_num_blocks=2, cal_feat_dim=8,
            cal_expansion_ratio=4)


def _variables(module, seed, *args, **kw):
    """flax variables of `module` for `args`, every leaf drawn from numpy:
    kernels ~ N(0, 1/fan_in), LayerNorm scales and weight-norm gains around
    0.5..1, weight-norm directions ~ N(0, 1), biases and phi small."""
    shapes = jax.eval_shape(lambda *a: module.init(jax.random.key(0), *a, **kw), *args)
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            a = rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name in ("scale", "g"):
            a = rng.rand(*s.shape) * 0.6 + 0.5
        elif name == "v":
            a = rng.randn(*s.shape)
        else:  # bias, b, phi
            a = rng.randn(*s.shape) * 0.1
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _apply(module, variables, *args, **kw):
    """The flax forward, jitted (eager flax compiles op by op: slower on the CPU)."""
    return jax.jit(lambda v, *a: module.apply(v, *a, **kw))(variables, *args)


def _port(module, fill, variables, prefix=""):
    b = jw.FlaxToTorch(variables)
    fill(b, prefix, "")
    module.load_state_dict(b.finish())
    return module.eval()


def _close(got, ref, tol=TOL, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    print(f"{what} max-abs {np.abs(got - ref).max():.3g}")
    np.testing.assert_allclose(got, ref, **tol)


# ---------------------------------------------------------------------------
# positional encoding, resize, heads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w,c,scale", [(24, 32, 3.0), (320, 128, 3.0), (7, 16, 1.0)])
def test_sine_pos_encoding_matches_jax(w, c, scale):
    ref = np.asarray(jt.sine_pos_encoding(w, c, scale)).astype(np.float32)
    got = tt.sine_pos_encoding(w, c, scale, torch.float32, torch.device("cpu"))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert tt.sine_pos_encoding(w, c, scale, torch.float32, torch.device("cpu")) is got
    idx = np.asarray(jt.rel_pos_matrix(jnp.asarray(ref), w))
    np.testing.assert_array_equal(tt.rel_pos_matrix(got, w).numpy(), idx)


@pytest.mark.parametrize("src,dst", [((4, 7), (34, 60)), ((1, 3), (3, 6)), ((5, 6), (5, 6))])
def test_resize_bilinear_matches_jax(src, dst):
    x = np.random.RandomState(0).randn(1, *src, 5).astype(np.float32)
    ref = np.asarray(jops.resize_bilinear(jnp.asarray(x), dst))
    _close(to_nhwc(ops.resize_bilinear(to_nchw(x), dst)), ref, what=f"resize {src}->{dst}")
    if src != dst:  # jax.image.resize antialiases a downsample: the port refuses one
        with pytest.raises(ValueError, match="only upsamples"):
            ops.resize_bilinear(to_nchw(ref), src)


def test_optimal_transport_and_low_res_disp_match_jax():
    rng = np.random.RandomState(1)
    attn = (rng.randn(2, 3, 20, 20) * 2).astype(np.float32)
    attn[0, 0] = np.where(np.triu(np.ones((20, 20)), 1) > 0, -np.inf, attn[0, 0])
    phi = np.float32(0.3)
    ref = np.asarray(js.optimal_transport(jnp.asarray(attn), jnp.asarray(phi)))
    got = ts.optimal_transport(torch.from_numpy(attn), torch.tensor(phi))
    _close(got.numpy(), ref, tol=dict(rtol=1e-5, atol=1e-6), what="optimal_transport")
    occ = (rng.rand(2, 3, 20) > 0.7).astype(np.float32)
    plan = ref[..., :-1, :-1].copy()
    plan[1, 1, 4] = 0.01  # a window below 0.1 keeps its mass
    for mask in (None, occ):
        rd, rm = js.low_res_disp(jnp.asarray(plan), None if mask is None else jnp.asarray(mask))
        gd, gm = ts.low_res_disp(torch.from_numpy(plan),
                                 None if mask is None else torch.from_numpy(mask))
        _close(gd.numpy(), np.asarray(rd), tol=dict(rtol=1e-6, atol=1e-6), what="low_res_disp")
        _close(gm.numpy(), np.asarray(rm), tol=dict(rtol=1e-6, atol=1e-6), what="matched")


def test_nearest_index_matches_jax():
    for n_out, n_in in ((540, 180), (960, 320), (48, 16), (37, 12)):
        ref = np.asarray(jnp.floor(jnp.arange(n_out) * (n_in / n_out)).astype(jnp.int32))
        np.testing.assert_array_equal(ts.nearest_index(n_out, n_in), ref)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_backbone_matches_flax():
    x = np.random.RandomState(2).randn(1, H, W, 3).astype(np.float32)
    fm = jb.SppBackboneIN()
    v = _variables(fm, 3, jnp.asarray(x), train=False)
    tm = _port(tb.SppBackboneIN(), jw.sttr_backbone, v)
    refs = _apply(fm, v, jnp.asarray(x), train=False)
    with torch.no_grad():
        gots = tm(to_nchw(x))
    # 17 conv + InstanceNorm layers: f32 summation-order noise reaches ~3e-5
    for i, (g, r) in enumerate(zip(gots, refs)):
        _close(to_nhwc(g), r, tol=dict(rtol=1e-4, atol=1e-4), what=f"SppBackboneIN out{i}")


def test_tokenizer_matches_flax():
    rng = np.random.RandomState(4)
    feats = [rng.randn(1, H // s, W // s, c).astype(np.float32)
             for s, c in ((1, 3), (4, 64), (8, 128), (16, 128))]
    fm = jb.Tokenizer(32)
    v = _variables(fm, 5, [jnp.asarray(f) for f in feats], train=False)
    tm = _port(tb.Tokenizer(32), jw.sttr_tokenizer, v)
    ref = _apply(fm, v, [jnp.asarray(f) for f in feats], train=False)
    with torch.no_grad():
        got = tm([to_nchw(f) for f in feats])
    assert got.shape == (1, 32, H, W)
    _close(to_nhwc(got), ref, what="Tokenizer")


def test_context_adjustment_matches_flax():
    rng = np.random.RandomState(6)
    args = [rng.randn(1, 12, 20, c).astype(np.float32) for c in (1, 1, 3)]
    fm = jb.ContextAdjustmentLayer(3, 8, 4)
    v = _variables(fm, 7, *[jnp.asarray(a) for a in args])
    tm = _port(tb.ContextAdjustmentLayer(3, 8, 4), jw.sttr_cal, v)
    rd, ro = _apply(fm, v, *[jnp.asarray(a) for a in args])
    with torch.no_grad():
        gd, go = tm(*[to_nchw(a) for a in args], torch.float32)
    _close(to_nhwc(gd), rd, what="CAL disparity")
    _close(to_nhwc(go), ro, what="CAL occlusion")


def test_wnconv_weight_follows_its_parameters():
    m = tb.WNConv(3, 4)
    torch.nn.init.normal_(m.weight_v)
    with torch.no_grad():
        a = m.weight(torch.float32)
        assert m.weight(torch.float32) is a
        np.testing.assert_allclose(a.flatten(1).norm(dim=1).numpy(), np.ones(4), rtol=1e-6)
        m.weight_g.mul_(2.0)
        b = m.weight(torch.float32)
    np.testing.assert_allclose(b.numpy(), 2 * a.numpy(), rtol=1e-6)


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("masked,need_raw", [(False, False), (True, True)])
def test_mha_relative_matches_flax(kernels, masked, need_raw):
    rng = np.random.RandomState(8)
    x, y = (rng.randn(3, 20, 32).astype(np.float32) for _ in range(2))
    table = np.asarray(jt.sine_pos_encoding(20, 32, 3.0)).astype(np.float32)
    fm = jt.MultiheadAttentionRelative(32, 4)
    kw = dict(pos_table=jnp.asarray(table), masked_last=masked, need_raw=need_raw)
    v = _variables(fm, 9, jnp.asarray(x), jnp.asarray(y), jnp.asarray(y), **kw)
    tm = set_kernels(_port(tt.MultiheadAttentionRelative(32, 4), jw._mha_relative, v), kernels)
    ref, ref_raw = _apply(fm, v, jnp.asarray(x), jnp.asarray(y), jnp.asarray(y), **kw)
    t = [torch.from_numpy(a) for a in (x, y, y)]
    with torch.no_grad():
        got, raw = tm(*t, pos_table=torch.from_numpy(table), masked_last=masked,
                      need_raw=need_raw)
    _close(got.numpy(), ref, tol=dict(rtol=1e-4, atol=1e-4), what=f"MHA kernels={kernels}")
    if need_raw:
        fin = np.isfinite(np.asarray(ref_raw))
        _close(raw.numpy()[fin], np.asarray(ref_raw)[fin], tol=dict(rtol=1e-4, atol=1e-4))
        assert (raw.numpy()[~fin] < -1e29).all()
    elif kernels:
        assert raw is None


def test_mha_relative_kernel_path_refuses_attn_mask():
    m = tt.MultiheadAttentionRelative(8, 2).eval()
    torch.nn.init.normal_(m.in_proj_weight)
    x = torch.randn(1, 5, 8)
    table = tt.sine_pos_encoding(5, 8, 1.0, torch.float32, torch.device("cpu"))
    with torch.no_grad(), pytest.raises(ValueError, match="attn_mask"):
        m(x, x, x, pos_table=table, attn_mask=torch.zeros(5, 5))


@pytest.mark.parametrize("kernels", [True, False])
def test_transformer_matches_flax(kernels):
    rng = np.random.RandomState(10)
    fl, fr = (rng.randn(1, 4, 24, 32).astype(np.float32) for _ in range(2))
    fm = jt.Transformer(32, 4, 2, remat=False)
    v = _variables(fm, 11, jnp.asarray(fl), jnp.asarray(fr), pos_scale=3.0)
    tm = set_kernels(_port(tt.Transformer(32, 4, 2), jw.sttr_transformer, v), kernels)
    ref = np.asarray(_apply(fm, v, jnp.asarray(fl), jnp.asarray(fr), pos_scale=3.0))
    with torch.no_grad():
        got = tm(to_nchw(fl), to_nchw(fr), pos_scale=3.0).numpy()
    assert got.shape == ref.shape == (1, 4, 24, 24)
    fin = np.isfinite(ref)
    _close(got[fin], ref[fin], tol=dict(rtol=1e-4, atol=1e-4), what=f"Transformer kernels={kernels}")
    assert (got[~fin] < -1e29).all() if kernels else np.isneginf(got[~fin]).all()


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    """(flax variables, NHWC inputs, flax outputs) — the module's one whole-model JAX run.

    `low_res_disp` takes an argmax, so a pixel whose two best matches tie
    to ~1e-6 may flip between any two correct implementations. The weight
    seed is one whose transport plan has no pixel within 0.1 % of a tie; the
    fixture checks that, so a flip cannot pass for a fault of the port.
    """
    rng = np.random.RandomState(12)
    left = rng.randn(1, H, W, 3).astype(np.float32)
    data = {"left": left, "right": np.roll(left, -6, axis=2)}
    model = js.STTR(**TINY)
    jdata = {k: jnp.asarray(a) for k, a in data.items()}
    variables = _variables(model, 14, jdata, train=False)
    out, inter = _apply(model, variables, jdata, train=False, capture_intermediates=True)
    raw = inter["intermediates"]["transformer"]["__call__"][0]
    plan = np.sort(np.asarray(js.optimal_transport(raw, variables["params"]["phi"]))[..., :-1, :-1])
    assert ((plan[..., -1] - plan[..., -2]) / plan[..., -1]).min() > 1e-3
    return variables, data, {k: np.asarray(a) for k, a in out.items()}


def _tiny_port(variables, kernels):
    m = STTR(**TINY)
    m.load_state_dict(jw.sttr_state_dict_from_jax(variables), strict=True)
    return set_kernels(m.eval(), kernels)


@pytest.mark.parametrize("kernels", [True, False])
def test_sttr_matches_flax(tiny, kernels):
    variables, data, ref = tiny
    model = _tiny_port(variables, kernels)
    with torch.inference_mode():
        out = model({k: to_nchw(a) for k, a in data.items()})
    assert out["disp_pred"].shape == (1, H, W) and out["disp_pred_low_res"].shape == (1, 16, 32)
    for key, tol in (("disp_pred", 1e-3), ("disp_pred_low_res", 1e-3), ("occ_pred", 1e-4)):
        got = out[key].numpy()
        print(f"STTR {key} (kernels={kernels}) vs flax: max-abs {np.abs(got - ref[key]).max():.3g}, "
              f"range {ref[key].min():.2f}..{ref[key].max():.2f}")
        np.testing.assert_allclose(got, ref[key], rtol=0, atol=tol)


def test_sttr_state_dict_round_trip_is_exact(tiny):
    """port state_dict → the JAX package's `convert_sttr` → the flax variables."""
    variables = tiny[0]
    sd = {k: v.numpy() for k, v in _tiny_port(variables, True).state_dict().items()}
    back = convert_sttr(sd, num_attn_layers=TINY["num_attn_layers"],
                        cal_num_blocks=TINY["cal_num_blocks"])
    assert back["batch_stats"] == {}
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])  # noqa: E731
    a, b = flat(back["params"]), flat(variables["params"])
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=str(k))


def test_sttr_state_dict_consumes_every_flax_leaf(tiny):
    variables = jax.tree_util.tree_map(np.asarray, tiny[0])
    variables["params"]["cal"]["extra"] = {"kernel": np.zeros((3, 3, 1, 1), np.float32)}
    with pytest.raises(ValueError, match="not consumed"):
        jw.sttr_state_dict_from_jax(variables)


def test_build_model_reads_the_sttr_config():
    cfg = load_config(str(CFG))
    model = build_model(cfg.MODEL, device="cpu", seed=0)
    assert isinstance(model, STTR) and not model.training
    assert len(model.transformer.self_attn_layers) == 6
    assert model.transformer.self_attn_layers[0].self_attn.num_heads == 8
    assert len(model.regression_head.cal.layers) == 8
    assert model.regression_head.cal.layers[0].module[0].weight_v.shape == (64, 17, 3, 3)
    ref_keys = set(convert_sttr({k: v.numpy() for k, v in model.state_dict().items()})["params"])
    assert ref_keys == {"backbone", "tokenizer", "transformer", "phi", "cal"}
    again = build_model(cfg.MODEL, device="cpu", seed=0).state_dict()
    assert all(torch.equal(t, again[k]) for k, t in model.state_dict().items())


def test_infer_cli_on_cpu_with_the_sttr_config(tmp_path):
    """The STTR config's transforms and MODEL section, cut to a tiny width
    and a 48×96 pad so that the CPU run stays short."""
    from PIL import Image

    from openstereo_tpu_torch.tools import infer

    cfg = yaml.safe_load(CFG.read_text())
    cfg["MODEL"].update({k.upper(): v for k, v in TINY.items()})
    cfg["DATA_CONFIG"]["DATA_TRANSFORM"]["EVALUATING"][0]["SIZE"] = [H, W]
    (tmp_path / "sttr.yaml").write_text(yaml.safe_dump(cfg))
    img = (np.random.RandomState(14).rand(44, 90, 3) * 255).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "left.png")
    Image.fromarray(np.roll(img, -6, axis=1)).save(tmp_path / "right.png")
    out = tmp_path / "disp.png"
    disp = infer.main(["--cfg_file", str(tmp_path / "sttr.yaml"),
                       "--left_img_path", str(tmp_path / "left.png"),
                       "--right_img_path", str(tmp_path / "right.png"),
                       "--out", str(out), "--device", "cpu"])
    assert disp.shape == (H, W) and np.isfinite(disp).all()
    png = np.asarray(Image.open(out))
    assert png.shape == (H, W) and png.dtype == np.uint16
