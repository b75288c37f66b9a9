"""Port MonSter vs the flax MonSter of the JAX package, eval, on the CPU.

A small model (96×160 input, encoder vits, max_disp 64, valid_iters 3 of
which mix_iters 2; every other width as the config's: hidden 128, 3 GRU
layers, 8 groups, 2 correlation levels, radius 4) with numpy-drawn flax
variables in flax's own tree (its training graph's, traced once, the
training heads included); the weights go JAX → port through
`monster_state_dict_from_jax`, which consumes every one of them, and back
through `convert_monster`. The flax forward is jitted once
(`run_jitted_fast`, 3D convs "native", ROADMAP 3d) and captures the ViT's
taps, the depth head, the pyramid decoder, `feat_transfer`, the stems, the
descriptors, the gated volume, the hourglass and the context, which the
module tests feed to the port's modules; it also records the
scale-and-shift alignment, its inputs and its result. The iteration
bodies, the update blocks, the UNet and REMP run on their own with the
model's variables or their own (flax op by op).

Tolerances: f32 modules within 1e-5·max|ref| (`within_scale`); the
alignment rtol 1e-5 on identical inputs; the whole model 2e-4 px; the bf16
`MixUpdateBlock` under rule 3a. On the CPU the K3 wrapper runs its plain
version, so "kernels on" checks its wiring.
"""

import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from openstereo_tpu.models.igev import geometry as jgeo
from openstereo_tpu.models.monster import blocks as jmb
from openstereo_tpu.models.monster import monster as jm
from openstereo_tpu.ops import sampler as jsampler
from openstereo_tpu.ops import upsample as jup
from openstereo_tpu.utils.torch_convert import convert_monster

from openstereo_tpu_torch import ops
from openstereo_tpu_torch.config import Config, load_config
from openstereo_tpu_torch.models import MODELS, NOT_PORTED, build_model, set_kernels
from openstereo_tpu_torch.models.igev.geometry import CombinedGeoEncodingVolume
from openstereo_tpu_torch.models.monster import MonSter
from openstereo_tpu_torch.models.monster import blocks as tmb
from openstereo_tpu_torch.models.monster import monster as tm
from openstereo_tpu_torch.utils import jax_weights as jw

import torch_train_step as ts
from test_torch_bf16_parity import assert_bf16_rule, to_torch
from test_torch_foundationstereo import within_scale
from test_torch_igev_rt import counted_plain_kernels
from test_torch_igevpp import _module_variables
from test_torch_layers import _random_like, run_jitted_fast
from test_torch_ops import to_nchw, to_nhwc
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
CFG = ROOT / "cfgs/monster/monster_sceneflow.yaml"
H, W = 96, 160
TINY = dict(max_disp=64, encoder="vits", valid_iters=3, mix_iters=2)
CAPTURED = ("mono", "mono_encoder", "mono_decoder", "feat_decoder", "feat_transfer", "stem_2b",
            "stem_4b", "stem_8b", "stem_16b", "desc", "corr_feature_att", "cost_agg",
            "feat_transfer_cnet")
HIDDEN = (128, 128, 128)
gwc_volume_mod = importlib.import_module("openstereo_tpu_torch.ops.gwc_volume")


def calls(inter, name):
    """Every capture of module `name` (the first module of that name found)."""
    for key, sub in inter.items():
        if key == name:
            return sub["__call__"]
        if isinstance(sub, dict) and key != "__call__":
            found = calls(sub, name)
            if found is not None:
                return found
    return None


def nchw(a):
    return to_nchw(np.asarray(a))


def taps_of(taps):
    return [(torch.from_numpy(np.array(t)), torch.from_numpy(np.array(c))) for t, c in taps]


@pytest.fixture(scope="module")
def reference():
    """(flax variables, NHWC images, flax disparity, captured outputs, the
    alignment's (scale, shift, mono, disp)): the module's one JAX compile."""
    rng = np.random.RandomState(0)
    data = {k: rng.randn(1, H, W, 3).astype(np.float32) for k in ("left", "right")}
    model = jm.MonSter(**TINY)
    images = {k: jnp.asarray(v) for k, v in data.items()}
    variables = _random_like(jax.eval_shape(lambda d: model.init(
        jax.random.key(0), d, train=True), images), 43)
    aligned = {}

    def recorded(mono, disp):
        out = jmb.compute_scale_shift(mono, disp)
        jax.debug.callback(lambda *a: aligned.update(jax=[np.array(x) for x in a]),
                           *out, mono, disp)
        return out

    with pytest.MonkeyPatch.context() as mp:
        for var in ("OPENSTEREO_CONV3D", "OPENSTEREO_DECONV3D"):
            mp.setenv(var, "native")
        mp.setattr(jm, "compute_scale_shift", recorded)
        out, state = run_jitted_fast(lambda v, b: model.apply(
            v, b, train=False, capture_intermediates=lambda m, _: m.name in CAPTURED,
            mutable=["intermediates"]), variables, images)
        jax.effects_barrier()
    return variables, data, np.asarray(out["disp_pred"]), state["intermediates"], aligned["jax"]


@pytest.fixture(scope="module")
def port(reference):
    model = MonSter(**TINY)
    model.load_state_dict(jw.monster_state_dict_from_jax(reference[0]))
    return model.eval()


def images(data):
    return to_nchw(data["left"]), to_nchw(data["right"])


# ----------------------------------------------------------------------- ops

@pytest.mark.parametrize("padding", ["border", "zeros"])
@pytest.mark.parametrize("unaligned", [True, False])
def test_disp_warp_matches_jax(padding, unaligned):
    """Sources beyond both edges, exactly on them and inside: the border
    clamp lands a source on W−1 (and the bottom row's sheared y on H−1),
    where the second tap must weigh 0; zeros padding with its valid mask."""
    rng = np.random.RandomState(20)
    b, h, w, c = 2, 9, 17, 5
    right = rng.randn(b, h, w, c).astype(np.float32)
    xs = np.arange(w, dtype=np.float32)
    disp = rng.uniform(-6, 22, (b, h, w)).astype(np.float32)
    disp[:, 0] = xs - (w - 1)      # x − d = W − 1: the right edge exactly
    disp[:, 1] = xs                # x − d = 0: the left edge exactly
    disp[:, 2] = xs - w - 3.25     # beyond the right edge
    disp[:, 3] = xs + 1.5          # beyond the left edge
    disp[:, 4] = np.round(disp[:, 4])  # whole-pixel sources
    ref, ref_valid = jsampler.disp_warp(jnp.asarray(right), jnp.asarray(disp), padding=padding,
                                        torch_unaligned=unaligned)
    got, valid = ops.disp_warp(to_nchw(right), torch.from_numpy(disp), padding,
                               torch_unaligned=unaligned)
    np.testing.assert_array_equal(to_nhwc(valid), np.asarray(ref_valid))
    within_scale(to_nhwc(got), ref, f"disp_warp {padding}, unaligned={unaligned}")
    assert np.asarray(ref_valid).min() == 0 and np.asarray(ref_valid).max() == 1
    with pytest.raises(ValueError, match="padding"):
        ops.disp_warp(to_nchw(right), torch.from_numpy(disp), "reflect")


def scale_shift_f64(mono, disp):
    """A plain numpy f64 reference of the alignment, per batch element."""
    out = []
    for m, d in zip(np.asarray(mono, np.float64), np.asarray(disp, np.float64)):
        thresh = np.sort(m.ravel())[int(0.2 * m.size)]
        w = ((d > 0) & (m > 1e-2) & (m > thresh)).astype(np.float64)
        a = np.array([[(w * m * m).sum() + 1e-6, (w * m).sum()], [(w * m).sum(), w.sum() + 1e-6]])
        out.append(np.linalg.solve(a, [(w * m * d).sum(), (w * d).sum()]))
    return np.array(out).T  # [scale, shift] × batch


def test_compute_scale_shift_matches_jax(reference):
    """On bit-identical inputs: the model's own (flax's mono depth at 1/4 and
    phase A's disparity) and a batch of 2 with ties at the threshold and
    masked-out pixels (disp <= 0, mono <= 1e-2). rtol 1e-5 against JAX, or,
    where the f32 normal equations cancel (the second set's shift: the two
    f32 sum orders differ by ~1.6e-5 of it), nearer the f64 solution than
    JAX's value is."""
    _, _, _, _, (_, _, mono, disp) = reference
    rng = np.random.RandomState(21)
    m2 = np.round(rng.uniform(-0.5, 4, (2, 24, 40)), 1).astype(np.float32)
    d2 = (3.0 * m2 + 2.0 + rng.randn(2, 24, 40) * 0.1).astype(np.float32)
    d2[:, :3] = -1.0
    for what, m, d in (("the model's inputs", mono, disp), ("ties, masked pixels", m2, d2)):
        ref = jmb.compute_scale_shift(jnp.asarray(m), jnp.asarray(d))
        got = tmb.compute_scale_shift(torch.from_numpy(np.array(m)), torch.from_numpy(np.array(d)))
        for name, g, r, e in zip(("scale", "shift"), got, ref, scale_shift_f64(m, d)):
            g, r = g.numpy().astype(np.float64), np.asarray(r, np.float64)
            print(f"compute_scale_shift ({what}) {name}: port {g}, JAX {r}, f64 {e}")
            close = np.abs(g - r) <= 1e-5 * np.abs(r)
            assert (close | (np.abs(g - e) <= np.abs(r - e))).all(), (what, name)
            if what == "the model's inputs":
                assert close.all(), name


# ----------------------------------------------------------------------- mono branches

VIT_HW = (84, 140)  # 96×160 ×14/16: 6×10 patches


def vit_input(data):
    """Both views resized ×14/16 as the jitted flax model resizes them. XLA
    folds the interpolation matrix's positions otherwise than JAX does op by
    op, and PyTorch's align-corners positions (a rounded scale times the
    index) round otherwise again: on these noise images the three resizes
    differ by up to ~7e-5 at values of ±4, each ~3-5e-5 from the exact one
    (`test_vit_input_resize_is_as_exact_as_jax_s`), and the ViT carries that
    to ~1e-5 of its taps. The module tests feed this input, so that they
    hold what follows the resize."""
    fn = lambda a: jup.resize_linear_align_corners(a, VIT_HW, axes=(1, 2))  # noqa: E731
    x = np.concatenate([np.asarray(run_jitted_fast(fn, jnp.asarray(data[k])))
                        for k in ("left", "right")])
    return to_nchw(x)


def test_vit_input_resize_is_as_exact_as_jax_s(reference):
    """The port's ×14/16 align-corners resize of the views against the exact
    (f64) resize: no further from it than the jitted flax model's, and
    within 1e-5 of the images' range."""
    _, data, _, _, _ = reference
    x = np.concatenate([data["left"], data["right"]]).astype(np.float64)
    exact = x
    for ax, n_out in ((1, VIT_HW[0]), (2, VIT_HW[1])):
        n_in = x.shape[ax]
        pos = np.arange(n_out) * (n_in - 1) / (n_out - 1)
        lo = np.minimum(np.floor(pos).astype(int), n_in - 2)
        frac = (pos - lo).reshape([-1 if a == ax else 1 for a in range(4)])
        exact = (np.take(exact, lo, axis=ax) * (1 - frac) + np.take(exact, lo + 1, axis=ax) * frac)
    with torch.inference_mode():
        got = to_nhwc(ops.resize_linear_align_corners(torch.cat(images(data)), VIT_HW))
    jax_err = np.abs(to_nhwc(vit_input(data)) - exact).max()
    err = np.abs(got - exact).max()
    print(f"×14/16 resize vs the exact one: port {err:.3g}, jitted flax {jax_err:.3g}, "
          f"max|x| {np.abs(x).max():.3g}")
    assert err <= jax_err and err <= 1e-5 * np.abs(x).max()


def test_vit_taps_match_flax(reference, port):
    """Both views resized ×14/16 (align corners: 96×160 → 84×140, 6×10
    patches; `vit_input`), the four normed taps and class tokens."""
    _, data, _, inter, _ = reference
    with torch.inference_mode():
        got = port.mono_encoder(vit_input(data))
    ref_l, ref_r = calls(inter, "mono_encoder")
    for i, ((gt, gc), (rt, rc)) in enumerate(zip(got, ref_l)):
        within_scale(gt[:1].numpy(), rt, f"ViT tap {i} tokens (left)")
        within_scale(gc[:1].numpy(), rc, f"ViT tap {i} class token (left)")
        within_scale(gt[1:].numpy(), ref_r[i][0], f"ViT tap {i} tokens (right)")


def test_depth_head_and_pyramid_decoder_match_flax(reference, port):
    """On flax's own taps: the DPT depth head (the frozen branch's relative
    depth) and the pyramid decoder's four paths, each at its own level."""
    _, _, _, inter, _ = reference
    taps_l, taps_r = calls(inter, "mono_encoder")
    with torch.inference_mode():
        _, depth = port.mono_decoder(taps_of(taps_l), 6, 10, depth=True)
        pyr = [port.feat_decoder(taps_of(t), 6, 10) for t in (taps_l, taps_r)]
    within_scale(depth.numpy(), calls(inter, "mono_decoder")[0][1], "DPT depth")
    for view, (got, ref) in enumerate(zip(pyr, calls(inter, "feat_decoder"))):
        assert [tuple(p.shape[2:]) for p in got] == [(24, 40), (12, 20), (6, 10), (3, 5)]
        for i, (g, r) in enumerate(zip(got, ref)):
            within_scale(to_nhwc(g), r, f"pyramid decoder view {view} p{i + 1}")


def test_mono_branches_match_flax(reference, port, monkeypatch):
    """`_MonoStereoBranches` whole, from the views resized as flax resizes
    them (`vit_input`): the relative depth at H×W (the depth head's 84×140
    resized up, half-pixel centres) and both views' pyramids."""
    _, data, _, inter, _ = reference
    resize = tm.resize_linear_align_corners
    monkeypatch.setattr(tm, "resize_linear_align_corners", lambda x, size: vit_input(data)
                        if tuple(size) == VIT_HW else resize(x, size))
    with torch.inference_mode():
        depth, pyr = port.mono_branches(*images(data))
    ref_depth, ref_l, ref_r = calls(inter, "mono")[0]
    within_scale(depth.numpy(), ref_depth, "mono depth at H×W")
    for i, p in enumerate(pyr):
        within_scale(to_nhwc(p[:1]), ref_l[i], f"mono pyramid p{i + 1} (left)")
        within_scale(to_nhwc(p[1:]), ref_r[i], f"mono pyramid p{i + 1} (right)")


# ----------------------------------------------------------------------- stereo branch

def test_feat_transfer_matches_flax(reference, port):
    """Both views. flax's model appends the stem's 48 channels to the list
    that FeatTransfer returned, so its capture of level 0 holds them too."""
    _, _, _, inter, _ = reference
    for view, (pyr, ref) in enumerate(zip(calls(inter, "feat_decoder"),
                                          calls(inter, "feat_transfer"))):
        with torch.inference_mode():
            got = port.feat_transfer([nchw(p) for p in pyr])
        assert got[0].shape[1] == 48 and ref[0].shape[-1] == 96
        for i, (g, r) in enumerate(zip(got, ref)):
            within_scale(to_nhwc(g), r[..., :g.shape[1]], f"FeatTransfer view {view} level {i}")


def test_stereo_features_match_flax(reference, port):
    """The stems (1/2 and 1/4 both views, 1/8 and 1/16 left) and the matching
    descriptors from flax's pyramids."""
    _, data, _, inter, _ = reference
    pyr = [torch.cat([nchw(a), nchw(b)]) for a, b in zip(*calls(inter, "feat_decoder"))]
    with torch.inference_mode():
        _, _, stems, ml, mr = port.stereo_features(*images(data), pyr)
    for s, name in zip(stems, ("stem_2b", "stem_4b", "stem_8b", "stem_16b")):
        within_scale(to_nhwc(s), calls(inter, name)[0], f"{name} (left)")
    ref_ml, ref_mr = calls(inter, "desc")
    within_scale(to_nhwc(ml), ref_ml, "match_left")
    within_scale(to_nhwc(mr), ref_mr, "match_right")


def flax_feats_l(inter):
    """The left features, level 0 with the stem's channels (as captured)."""
    return [nchw(x) for x in calls(inter, "feat_transfer")[0]]


def test_volume_and_hourglass_match_flax(reference, port):
    """From flax's descriptors: K3's plain version, the 3D stem and its
    feature gate; the hourglass (IGEV's, MonsterHourglass's leaky_relu 0.01
    and norm-free conv1_up) on flax's own gated volume."""
    _, _, _, inter, _ = reference
    feats = flax_feats_l(inter)
    ml, mr = (nchw(x) for x in calls(inter, "desc"))
    with torch.inference_mode():
        gated = port.corr_feature_att(port.corr_stem(ops.gwc_volume(ml, mr, 16, 8)), feats[0])
        ref_gated = calls(inter, "corr_feature_att")[0]
        within_scale(np.moveaxis(gated.numpy(), 1, -1), ref_gated, "gated gwc volume")
        got = port.cost_agg(torch.from_numpy(np.ascontiguousarray(
            np.moveaxis(np.asarray(ref_gated), -1, 1))), feats)
    within_scale(np.moveaxis(got.numpy(), 1, -1), calls(inter, "cost_agg")[0], "MonsterHourglass")


def test_feat_transfer_cnet_matches_flax(reference, port):
    _, _, _, inter, _ = reference
    pyr = [nchw(p) for p in calls(inter, "feat_decoder")[0]]
    stems = [nchw(calls(inter, n)[0]) for n in ("stem_16b", "stem_8b", "stem_4b")]
    with torch.inference_mode():
        got = port.feat_transfer_cnet(pyr, stems)
    for s, ((g, g2), (r, _)) in enumerate(zip(got, calls(inter, "feat_transfer_cnet")[0])):
        assert g is g2
        within_scale(to_nhwc(g), r, f"FeatTransferCnet scale {s}")


# ----------------------------------------------------------------------- GRU iterations

def gru_state(seed, sizes, cor_geo=(16, 4)):
    """Random net, inp (cz, cr, cq), the two pyramids' sources and the
    disparities at the GRU scales; NHWC (JAX) and the port's."""
    rng = np.random.RandomState(seed)
    (h4, w4) = sizes[0]
    net = [np.tanh(rng.randn(1, h, w, 128)).astype(np.float32) for h, w in sizes]
    inp = [tuple(rng.randn(1, h, w, 128).astype(np.float32) * 0.5 for _ in range(3))
           for h, w in sizes]
    d, c = cor_geo
    ml, mr = (rng.randn(1, h4, w4, 96).astype(np.float32) * 0.2 for _ in range(2))
    geo = rng.randn(1, d, h4, w4, 8).astype(np.float32)
    disp = rng.uniform(-2, 14, (1, h4, w4, 1)).astype(np.float32)
    disp_m = rng.uniform(0, 12, (1, h4, w4, 1)).astype(np.float32)
    feats = [rng.randn(1, h4, w4, 96).astype(np.float32) for _ in range(2)]
    return net, inp, ml, mr, geo, disp, disp_m, feats


def port_geo(ml, mr, geo):
    return CombinedGeoEncodingVolume(nchw(ml), nchw(mr), torch.from_numpy(
        np.ascontiguousarray(np.transpose(geo, (0, 4, 1, 2, 3)))), 2, 4)


SIZES = [(12, 20), (6, 10), (3, 5)]


def test_iteration_a_matches_flax(reference, port):
    """`_MonsterIterationA` (IGEV's iteration without slow-fast calls) with the
    model's `gru_loop` variables against `IGEVFamily.gru_iteration`."""
    net, inp, ml, mr, geo, disp, _, _ = gru_state(30, SIZES)
    coords = np.broadcast_to(np.arange(20, dtype=np.float32), (1, 12, 20))
    fm = jm._MonsterIterationA(HIDDEN, 3, 4, 2)

    def run(params, net, disp, inp, coords, ml, mr, geo):
        g = jgeo.CombinedGeoEncodingVolume(ml, mr, geo, 2, 4)
        return fm.apply({"params": params}, (tuple(net), disp),
                        (g.geo_lookup, g.corr_lookup, tuple(inp), coords))

    (rnet, rdisp), (_, rmask) = run_jitted_fast(run, reference[0]["params"]["gru_loop"], net,
                                                disp, inp, coords, ml, mr, geo)
    with torch.inference_mode():
        gnet, gdisp, gmask = port.gru_iteration(
            [nchw(x) for x in net], [tuple(nchw(c) for c in i) for i in inp],
            port_geo(ml, mr, geo), torch.from_numpy(coords.copy()), nchw(disp))
    within_scale(to_nhwc(gdisp), rdisp, "iteration A disparity")
    within_scale(to_nhwc(gmask), rmask, "iteration A mask features")
    for i, (a, r) in enumerate(zip(gnet, rnet)):
        within_scale(to_nhwc(a), r, f"iteration A net[{i}]")


def test_iteration_b_matches_flax(reference, port):
    """`_MonsterIterationB` with the model's `gru_loop_mix` variables against
    `MonSter.mix_iteration`: both warps of the right 1/4 features (border,
    sheared; disparities beyond both edges), both lookups, the twin blocks."""
    net, inp, ml, mr, geo, disp, disp_m, (fl, fr) = gru_state(31, SIZES)
    net_m = [np.tanh(x * 1.3) for x in net]
    coords = np.broadcast_to(np.arange(20, dtype=np.float32), (1, 12, 20))
    fm = jm._MonsterIterationB(HIDDEN, 3, 4, 2)

    def run(params, net, net_m, disp, disp_m, inp, coords, fl, fr, ml, mr, geo):
        g = jgeo.CombinedGeoEncodingVolume(ml, mr, geo, 2, 4)
        return fm.apply({"params": params}, (tuple(net), tuple(net_m), disp, disp_m),
                        (g.geo_lookup, g.corr_lookup, tuple(inp), coords, fl, fr))

    (rnet, rnet_m, rd, rdm), (_, rmask, _, rmask_m) = run_jitted_fast(
        run, reference[0]["params"]["gru_loop_mix"], net, net_m, disp, disp_m, inp, coords, fl,
        fr, ml, mr, geo)
    with torch.inference_mode():
        gnet, gnet_m, gd, gdm, gmask, gmask_m = port.mix_iteration(
            [nchw(x) for x in net], [nchw(x) for x in net_m],
            [tuple(nchw(c) for c in i) for i in inp], port_geo(ml, mr, geo),
            torch.from_numpy(coords.copy()), nchw(fl), nchw(fr), nchw(disp), nchw(disp_m))
    for what, a, r in (("disparity", gd, rd), ("mono disparity", gdm, rdm),
                       ("mask features", gmask, rmask), ("mono mask features", gmask_m, rmask_m)):
        within_scale(to_nhwc(a), r, f"iteration B {what}")
    for i in range(3):
        within_scale(to_nhwc(gnet[i]), rnet[i], f"iteration B net[{i}]")
        within_scale(to_nhwc(gnet_m[i]), rnet_m[i], f"iteration B mono net[{i}]")


def mix_inputs(seed, dtype=jnp.float32):
    rng = np.random.RandomState(seed)
    h, w = 6, 10
    a = lambda *s: jnp.asarray(rng.randn(1, h, w, *s).astype(np.float32))  # noqa: E731
    disp = jnp.asarray(rng.uniform(0, 9, (1, h, w, 1)).astype(np.float32))
    disp_o = jnp.asarray(rng.uniform(0, 9, (1, h, w, 1)).astype(np.float32))
    corr, corr_o = a(162).astype(dtype), a(162).astype(dtype)
    return disp, corr, a(96), disp_o, corr_o, a(96)


def test_mix_motion_encoder_matches_flax():
    """Both branches' convs and the 63 + 1 + 63 + 1 = 128 output layout."""
    args = mix_inputs(40)
    fm = jmb.MixMotionEncoder()
    v = _module_variables(fm, args, 41)
    b = jw.FlaxToTorch(v)
    for k in ("convc1", "convc2", "convd1", "convd2", "conv"):
        for sfx in ("", "_mono"):
            b.conv(f"{k}{sfx}", f"{k}{sfx}", raw=True)
    tm_ = tmb.MixMotionEncoder(162, 96)
    tm_.load_state_dict(b.finish())
    ref = fm.apply(v, *args)
    with torch.inference_mode():
        got = tm_(*(nchw(x) for x in args))
    assert got.shape == (1, 128, 6, 10)
    within_scale(to_nhwc(got), ref, "MixMotionEncoder")
    np.testing.assert_array_equal(got[:, 63].numpy(), nchw(args[0])[:, 0].numpy())
    np.testing.assert_array_equal(got[:, 127].numpy(), nchw(args[3])[:, 0].numpy())


def mix_block_args(seed, dtype):
    rng = np.random.RandomState(seed)
    net = [jnp.asarray(np.tanh(rng.randn(1, h, w, 128)).astype(np.float32)).astype(dtype)
           for h, w in ((6, 10), (3, 5), (2, 3))]
    inp = [tuple(jnp.asarray(rng.randn(1, h, w, 128).astype(np.float32) * 0.5).astype(dtype)
                 for _ in range(3)) for h, w in ((6, 10), (3, 5), (2, 3))]
    disp, corr, flaw, disp_o, corr_o, flaw_o = mix_inputs(seed + 1, dtype)
    return net, inp, (flaw, disp, corr, flaw_o, disp_o, corr_o)


def port_mix_block(variables):
    b = jw.FlaxToTorch(variables)
    jw.mix_update_block(b, "", "")
    block = tmb.MixUpdateBlock(HIDDEN, 3, 162, 96)
    block.load_state_dict(b.finish())
    return block.eval()


def test_mix_update_block_matches_flax(reference):
    """The twin block with the model's `update_mix_mono` variables: the three
    GRUs, the returned hidden states, mask features and update."""
    net, inp, args = mix_block_args(42, jnp.float32)
    params = {"params": reference[0]["params"]["gru_loop_mix"]["update_mix_mono"]}
    rnet, rmask, rdelta = run_jitted_fast(jmb.MixUpdateBlock(HIDDEN, 3).apply, params, net, inp,
                                          *args)
    block = port_mix_block(params)
    with torch.inference_mode():
        gnet, gmask, gdelta = block(
            [nchw(x) for x in net], [tuple(nchw(c) for c in i) for i in inp],
            *(nchw(x) for x in args))
    within_scale(to_nhwc(gmask), rmask, "MixUpdateBlock mask features")
    within_scale(to_nhwc(gdelta), rdelta, "MixUpdateBlock disparity update")
    for i, (g, r) in enumerate(zip(gnet, rnet)):
        within_scale(to_nhwc(g), r, f"MixUpdateBlock net[{i}]")


def test_mix_update_block_bf16(monkeypatch):
    """bf16, flax op by op (ROADMAP 3c), with flax's three known roundings
    taken as the port takes them: each sigmoid rounded once (3j), the 3×3
    pools summed in f32 and rounded once (3e), and the align-corners
    resizes the port's own f32 resize rounded once (3b; the f32 positions of
    PyTorch's and JAX's resizes round apart, which flips ~1e-3 of the
    resized bf16 states by a unit, and the next GRU's convs spread each
    flip over 3×3×128 outputs; the resize is held in `tests/test_torch_ops.py`).
    The f32 disparities and warp errors ride in f32 and are cast by the
    convs that read them. Held to rule 3a (read: bit-equal)."""
    from openstereo_tpu.models.igev import update as jupdate

    def once(fn):
        return lambda x, *a: fn(x.astype(jnp.float32), *a).astype(x.dtype)

    def port_interp(x, dest):
        with torch.no_grad():
            y = tmb.interp_to(to_torch(x), torch.empty(1, 1, *dest.shape[1:3]))
        return jnp.asarray(np.moveaxis(y.float().numpy(), 1, -1)).astype(x.dtype)

    net, inp, args = mix_block_args(43, jnp.bfloat16)
    fm = jmb.MixUpdateBlock(HIDDEN, 3, dtype=jnp.bfloat16)
    v = _random_like(jax.eval_shape(lambda *a: fm.init(jax.random.key(0), *a), net, inp, *args),
                     44)
    monkeypatch.setattr(jupdate.nn, "sigmoid", once(jax.nn.sigmoid))
    monkeypatch.setattr(jmb, "pool2x", once(jupdate.pool2x))
    monkeypatch.setattr(jmb, "interp_to", port_interp)
    rnet, rmask, rdelta = fm.apply(v, net, inp, *args)
    t = lambda x: to_torch(x) if x.dtype == jnp.bfloat16 else nchw(x)  # noqa: E731
    block = port_mix_block(v)
    with torch.inference_mode():
        gnet, gmask, gdelta = block([t(x) for x in net],
                                                [tuple(t(c) for c in i) for i in inp],
                                                *(t(x) for x in args))
    assert gmask.dtype == gdelta.dtype == torch.bfloat16
    assert_bf16_rule(gmask, rmask, "MixUpdateBlock bf16 mask features")
    assert_bf16_rule(gdelta, rdelta, "MixUpdateBlock bf16 disparity update")
    for i, (g, r) in enumerate(zip(gnet, rnet)):
        assert_bf16_rule(g, r, f"MixUpdateBlock bf16 net[{i}]")


# ----------------------------------------------------------------------- refinement

@pytest.mark.parametrize("deconv", [False, True])
def test_conv2x_now_matches_flax(deconv):
    """BatchNorm and plain ReLU after each conv."""
    rng = np.random.RandomState(50 + deconv)
    x = jnp.asarray(rng.randn(1, 6, 10, 24).astype(np.float32) if deconv
                    else rng.randn(1, 12, 20, 24).astype(np.float32))
    rem = jnp.asarray(rng.randn(1, 12, 20, 16).astype(np.float32) if deconv
                      else rng.randn(1, 6, 10, 16).astype(np.float32))
    fm = jmb.Conv2xNow(16, deconv=deconv)
    v = _module_variables(fm, (x, rem), 52)
    b = jw.FlaxToTorch(v)
    for c in ("conv1", "conv2"):
        b.conv(c, f"{c}.conv", deconv=deconv and c == "conv1")
        b.bn(c, f"{c}.bn")
    tm_ = tmb.Conv2xNow(24, 16, deconv=deconv)
    tm_.load_state_dict(b.finish())
    with torch.inference_mode():
        got = tm_.eval()(nchw(x), nchw(rem))
    within_scale(to_nhwc(got), fm.apply(v, x, rem), f"Conv2xNow deconv={deconv}")


def test_remp_matches_flax(reference, port):
    """REMP with the model's variables on its own at 48×80 (the UNet to 1/16,
    the dilated convs), disparities sending the warps beyond both edges:
    its warp errors, leaky_relu 0.2, the gates, the final leaky_relu 0.01."""
    rng = np.random.RandomState(60)
    h, w = 48, 80
    left, right = (rng.randn(1, h, w, 3).astype(np.float32) for _ in range(2))
    dm = rng.uniform(-8, 90, (1, h, w, 1)).astype(np.float32)
    ds = rng.uniform(-8, 90, (1, h, w, 1)).astype(np.float32)
    v = {c: reference[0][c]["REMP"] for c in ("params", "batch_stats")}
    ref = run_jitted_fast(jmb.REMP().apply, v, dm, ds, left, right)
    with torch.inference_mode():
        got = port.REMP(*(nchw(a) for a in (dm, ds, left, right)), port.dtype)
    within_scale(to_nhwc(got), ref, "REMP")


# ----------------------------------------------------------------------- whole model

@pytest.mark.parametrize("kernels", [True, False])
def test_monster_matches_flax(reference, port, kernels, monkeypatch):
    """The small model in f32 within 2e-4 px; its alignment's scale and shift
    beside flax's (relative error printed: a pixel crossing the 20 %
    threshold would show there first)."""
    _, data, ref, _, (s, t, _, _) = reference
    seen = {}

    def recorded(mono, disp):
        out = tmb.compute_scale_shift(mono, disp)
        seen["st"] = [float(x[0]) for x in out]
        return out

    monkeypatch.setattr(tm, "compute_scale_shift", recorded)
    with torch.inference_mode():
        got = set_kernels(port, kernels)(dict(zip(("left", "right"), images(data))))[
            "disp_pred"].numpy()
    set_kernels(port, True)
    assert got.shape == ref.shape == (1, H, W)
    rel = [abs(a - float(b[0])) / abs(float(b[0])) for a, b in zip(seen["st"], (s, t))]
    print(f"MonSter port (kernels={kernels}) vs flax: max-abs {np.abs(got - ref).max():.3g} px, "
          f"disparity range {ref.min():.2f}..{ref.max():.2f}; scale {seen['st'][0]:.7g} "
          f"(flax {float(s[0]):.7g}), shift {seen['st'][1]:.7g} (flax {float(t[0]):.7g}), "
          f"relative errors {rel[0]:.3g}, {rel[1]:.3g}")
    assert max(rel) < 1e-3, "the alignment moved: a pixel crossed the threshold"
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4)


def test_monster_state_dict_round_trip_is_exact(reference, port):
    """port state_dict → the JAX package's converter → the flax variables."""
    back = convert_monster({k: v.numpy() for k, v in port.state_dict().items()})
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])  # noqa: E731
    a, b = flat(back), flat(reference[0])
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=str(k))


def test_load_pretrained_skips_the_reference_only_modules(port, tmp_path):
    """A reference checkpoint also holds modules the reference never runs
    (`convert_monster` drops them): `load_pretrained` skips them."""
    from openstereo_tpu_torch.tools.infer import load_pretrained

    sd = {k: v.clone() for k, v in port.state_dict().items()}
    extra = {"mono_encoder.mask_token": torch.zeros(1, 384),
             "mono_decoder.scratch.refinenet4.resConfUnit1.conv1.weight": torch.zeros(64, 64, 3, 3),
             "feat_decoder.scratch.refinenet4.resConfUnit1.conv2.bias": torch.zeros(64),
             "cost_agg.conv1_up.bn.running_mean": torch.zeros(8)}
    assert all(k.startswith(MonSter.REFERENCE_ONLY_KEYS) for k in extra)
    torch.save({"model_state": {**sd, **extra}}, tmp_path / "monster.pth")
    with torch.device("meta"):
        model = MonSter(**TINY)
    model.to_empty(device="cpu")
    assert load_pretrained(model, str(tmp_path / "monster.pth")) == len(sd)
    assert all(torch.equal(model.state_dict()[k], v) for k, v in sd.items())


def test_build_model_runs_the_config_on_the_cpu_through_the_plain_k3(reference, monkeypatch):
    """At full width (vits, D/4 48, 32 iterations of which 7 mixed) on the
    CPU: as many parameters as flax's tree of the small model, whose widths
    are the config's (max_disp and the iterations hold none), the training
    heads `spx_4`, `spx_2`, `spx` included; on a 64×128 pair with the loop
    cut to 1 + 7 iterations for time, a finite disparity, K3 once at D 48 G 8
    (its plain version) and no K2; a training forward (the config's 22
    iterations, 15 + 7 mutual) gives the initial disparity, the mono depth
    and 15 + 2·7 = 29 iterates at the images' size, through the plain
    volume, not K3's wrapper."""
    calls_ = counted_plain_kernels(monkeypatch)
    cfg = load_config(str(CFG))
    assert "MonSter" in MODELS and "MonSter" not in NOT_PORTED
    model = build_model(cfg.MODEL, device="cpu", seed=0)
    assert isinstance(model, MonSter) and not model.training
    assert (model.encoder, model.max_disp // 4, model.valid_iters, model.mix_iters,
            model.n_gru_layers, model.corr_levels, model.corr_radius) == ("vits", 48, 32, 7, 3,
                                                                          2, 4)
    x = torch.rand(1, 3, 64, 128, generator=torch.Generator().manual_seed(0)) * 2 - 1
    n_flax = sum(a.size for a in jax.tree_util.tree_leaves(reference[0]["params"]))
    n_port = sum(p.numel() for p in model.parameters())
    print(f"MonSter at full width: {n_port} parameters; flax's tree {n_flax}")
    assert n_port == n_flax
    model.valid_iters = 8
    seen = []
    plain = gwc_volume_mod.gwc_volume_plain
    monkeypatch.setattr(gwc_volume_mod, "gwc_volume_plain",
                        lambda *a: seen.append((tuple(a[0].shape),) + a[2:]) or plain(*a))
    with torch.inference_mode():
        disp = model({"left": x, "right": x.roll(-3, dims=-1)})["disp_pred"]
    assert disp.shape == (1, 64, 128) and torch.isfinite(disp).all()
    assert seen == [((1, 96, 16, 32), 48, 8, 12)] and calls_["mbconv"] == 0
    assert (model.train_iters, model.mix_iters) == (22, 7)
    with torch.no_grad():
        out = ts.check_training_outputs(model, {"left": x, "right": x.roll(-3, dims=-1)},
                                        n_preds=29)
    assert out["depth_mono"].shape == (1, 64, 128)
    assert len(seen) == 1
    with pytest.raises(NotImplementedError):
        build_model(Config.from_dict({"NAME": "AANet"}), device="cpu")
