"""Port FoundationStereo vs the flax FoundationStereo of the JAX package, eval,
on the CPU.

A small model (64×96 input, ViT vits, max_disp 64, valid_iters 2; every
other width as the config's: hidden 128, 3 GRU layers, volume 28, 8 cosine
groups, 2 correlation levels, radius 4) with numpy-drawn flax variables of
the graph, in the tree that `convert_foundationstereo` makes of the port's
state_dict; the weights go JAX → port through
`foundationstereo_state_dict_from_jax`. The flax forward is jitted once
(`run_jitted_fast`, 3D convs in the "native" lowering, ROADMAP 3d) and
captures the ViT's taps (its 112×112 input resizes the position table
from 37×37 to 8×8), the DPT head, the EdgeNeXt trunk, the features, the
gated volume, the AHCF hourglass and the context net, which the module
tests feed to the port's modules. The update block runs on its own with
the model's variables; `DispTransformerLayer`, `SelectiveConvGRU` and the
bf16 blocks with their own (un-jitted in bf16, ROADMAP 3c).

Tolerances: f32 modules within 1e-5·max|ref| (`within_scale`); the whole
model 2e-4 px; bf16 blocks rule 3a (`assert_bf16_rule`). On the CPU the K3
wrapper runs its plain version, so "kernels on" checks its wiring.
"""

import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from openstereo_tpu.models.backbones import dinov2 as jdino
from openstereo_tpu.models.backbones import edgenext as jedge
from openstereo_tpu.models.foundationstereo import blocks as jfsb
from openstereo_tpu.models.foundationstereo import foundationstereo as jfs
from openstereo_tpu.ops import upsample as jup
from openstereo_tpu.utils.torch_convert import convert_foundationstereo

from openstereo_tpu_torch import ops
from openstereo_tpu_torch.config import Config, load_config
from openstereo_tpu_torch.models import NOT_PORTED, build_model, set_kernels
from openstereo_tpu_torch.models.backbones import dinov2 as tdino
from openstereo_tpu_torch.models.backbones import edgenext as tedge
from openstereo_tpu_torch.models.foundationstereo import FoundationStereo
from openstereo_tpu_torch.models.foundationstereo import blocks as tfsb
from openstereo_tpu_torch.models.layers import gelu
from openstereo_tpu_torch.tools.bench import eval_size
from openstereo_tpu_torch.utils import jax_weights as jw

import torch_train_step as ts
from test_torch_bf16_parity import FLIP_SHARE, bf16_units
from test_torch_igev_rt import counted_plain_kernels
from test_torch_igevpp import _module_variables
from test_torch_layers import _random_variables_via, run_jitted_fast
from test_torch_ops import to_nchw, to_nhwc
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
CFG = ROOT / "cfgs/foundationstereo/fstereo_foundationstereo.yaml"
H, W = 64, 96
TINY = dict(max_disp=64, vit_size="vits", valid_iters=2)
CAPTURED = ("pretrained", "dino", "trunk", "feature", "corr_feature_att", "cost_agg", "cnet")
gwc_volume_mod = importlib.import_module("openstereo_tpu_torch.ops.gwc_volume")


def within_scale(got, ref, what, rel=1e-5):
    """max-abs within rel·max|ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    print(f"{what}: max-abs {err:.3g}, max|ref| {scale:.3g} ({err / scale:.3g} of it)")
    assert err <= rel * scale, f"{what}: max-abs {err} > {rel}·{scale}"


def captured(inter, name):
    """The first capture of module `name` anywhere in the tree."""
    for key, sub in inter.items():
        if key == name:
            return sub["__call__"][0]
        if isinstance(sub, dict) and key != "__call__":
            found = captured(sub, name)
            if found is not None:
                return found
    return None


@pytest.fixture(scope="module")
def reference():
    """(flax variables, NHWC images, flax disparity, captured outputs): the
    module's one JAX compile."""
    rng = np.random.RandomState(0)
    data = {k: rng.randn(1, H, W, 3).astype(np.float32) for k in ("left", "right")}
    variables = _random_variables_via(convert_foundationstereo, FoundationStereo(**TINY), 43)
    model = jfs.FoundationStereo(**TINY)
    with pytest.MonkeyPatch.context() as mp:
        for var in ("OPENSTEREO_CONV3D", "OPENSTEREO_DECONV3D"):
            mp.setenv(var, "native")
        out, state = run_jitted_fast(lambda v, b: model.apply(
            v, b, train=False, capture_intermediates=lambda m, _: m.name in CAPTURED,
            mutable=["intermediates"]), variables, {k: jnp.asarray(v) for k, v in data.items()})
    return variables, data, np.asarray(out["disp_pred"]), state["intermediates"]


@pytest.fixture(scope="module")
def port(reference):
    model = FoundationStereo(**TINY)
    model.load_state_dict(jw.foundationstereo_state_dict_from_jax(reference[0]))
    return model.eval()


def both_views(data):
    """The siamese batch [left; right], NHWC and NCHW."""
    x = np.concatenate([data["left"], data["right"]], axis=0)
    return x, to_nchw(x)


# ----------------------------------------------------------------------- ops

@pytest.mark.parametrize("src,dst", [((64, 96), (112, 112)), ((50, 70), (28, 42))])
def test_resize_bicubic_matches_jax(src, dst):
    """Up (FoundationStereo's ViT input) and down, f32; in bf16 the port is one
    rounding of its f32 resize, where JAX's matrices in bf16 round more (3b)."""
    x = np.random.RandomState(1).randn(2, *src, 3).astype(np.float32)
    ref = jup.resize_bicubic_torch(jnp.asarray(x), dst, axes=(1, 2))
    got = ops.resize_bicubic_torch(to_nchw(x), dst)
    within_scale(to_nhwc(got), ref, f"bicubic {src} → {dst}")
    x16 = to_nchw(x).bfloat16()
    assert torch.equal(ops.resize_bicubic_torch(x16, dst),
                       ops.resize_bicubic_torch(x16.float(), dst).bfloat16())


def test_cosine_and_concat_volumes_match_jax():
    """The cosine group-wise volume (8 groups of 28, D 20 > W/4 planes beyond
    the frame) through the plain builder and through K3's wrapper with divisor
    1, and the FS concat volume with its un-zeroed left half; f32, and the
    cosine volume in bf16 under rule 3a against JAX's un-jitted builder."""
    rng = np.random.RandomState(2)
    left, right = (rng.randn(1, 6, 18, 224).astype(np.float32) for _ in range(2))
    ref = np.moveaxis(np.asarray(jfs.build_cosine_gwc_volume(
        jnp.asarray(left), jnp.asarray(right), 20, 8)), -1, 1)
    tl, tr = to_nchw(left), to_nchw(right)
    plain = ops.build_cosine_gwc_volume(tl, tr, 20, 8)
    within_scale(plain.numpy(), ref, "cosine volume")
    wired = ops.gwc_volume(ops.normalize_groups(tl, 8), ops.normalize_groups(tr, 8), 20, 8, 1)
    assert torch.equal(wired, plain)
    assert not plain[:, :, 18:].any()
    cat_ref = np.moveaxis(np.asarray(jfs.build_fs_concat_volume(
        jnp.asarray(left[..., :12]), jnp.asarray(right[..., :12]), 20)), -1, 1)
    cat = ops.build_fs_concat_volume(tl[:, :12], tr[:, :12], 20)
    np.testing.assert_array_equal(cat.numpy(), cat_ref)
    ref16 = np.moveaxis(np.asarray(jfs.build_cosine_gwc_volume(
        jnp.asarray(left, jnp.bfloat16), jnp.asarray(right, jnp.bfloat16), 20, 8),
        np.float32), -1, 1)
    got16 = ops.build_cosine_gwc_volume(tl.bfloat16(), tr.bfloat16(), 20, 8).float().numpy()
    units = bf16_units(got16, ref16)
    print(f"bf16 cosine volume: {(units > 0).mean():.3g} not bit-equal, max {units.max()} units")
    assert units.max() <= 1 and (units > 0).mean() <= FLIP_SHARE
    with pytest.raises(ValueError, match="divisor"):
        ops.gwc_volume(tl, tr, 20, 8, 2)


# ----------------------------------------------------------------------- backbones

def test_dino_vit_matches_flax(reference, port):
    """vits on the 112×112 bicubic-resized views: the position table resized
    37×37 → 8×8, the four normed taps and class tokens."""
    _, data, _, inter = reference
    x, _ = both_views(data)
    x_vit = jup.resize_bicubic_torch(jnp.asarray(x), (112, 112), axes=(1, 2))
    with torch.inference_mode():
        got = port.feature.dino.depth_anything.pretrained(to_nchw(x_vit))
    ref = captured(inter, "pretrained")
    assert len(got) == len(ref) == 4
    for i, ((gt, gc), (rt, rc)) in enumerate(zip(got, ref)):
        within_scale(gt.numpy(), rt, f"ViT tap {i} tokens")
        within_scale(gc.numpy(), rc, f"ViT tap {i} class token")


def test_dpt_head_matches_flax(reference, port):
    """The DPT head on flax's own taps: the feature after the resize to the
    ViT input, and the relative-depth branch."""
    _, _, _, inter = reference
    taps = [(torch.from_numpy(np.array(t)), torch.from_numpy(np.array(c)))
            for t, c in captured(inter, "pretrained")]
    with torch.inference_mode():
        feat, depth = port.feature.dino.depth_anything.depth_head(taps, 8, 8, depth=True)
    ref_feat, ref_depth = captured(inter, "dino")
    within_scale(to_nhwc(feat), ref_feat, "DPT feature")
    within_scale(depth.numpy(), ref_depth, "DPT depth")


def test_edgenext_trunk_matches_flax(reference, port):
    """The four stages (ConvEncoders, the SDTA blocks with XCA and, in stage 2,
    the Fourier position table), both views."""
    _, data, _, inter = reference
    _, x = both_views(data)
    with torch.inference_mode():
        got = port.feature.trunk(x)
    for i, (g, r) in enumerate(zip(got, captured(inter, "trunk"))):
        within_scale(to_nhwc(g), r, f"EdgeNeXt stage {i}")


def test_fourier_table_is_jax_s():
    np.testing.assert_array_equal(tedge.fourier_pos_table(5, 7),
                                  np.asarray(jedge._fourier_pos_table(5, 7)))
    np.testing.assert_array_equal(tfsb.sincos_table(26, 28), jfsb._sincos_table(26, 28))
    np.testing.assert_array_equal(tdino._torch_bicubic_matrix(37, 40, 40.1 / 37),
                                  jdino._torch_bicubic_matrix(37, 40, 40.1 / 37))


def test_features_match_flax(reference, port):
    """FSFeature whole: the trunk, the decoder and the ViT features at 1/4."""
    _, data, _, inter = reference
    _, x = both_views(data)
    with torch.inference_mode():
        feats, vit = port.feature(x, port.dtype)
    ref_feats, ref_vit = captured(inter, "feature")
    for i, (g, r) in enumerate(zip(feats, ref_feats)):
        within_scale(to_nhwc(g), r, f"features level {i}")
    within_scale(to_nhwc(vit), ref_vit, "ViT features at 1/4")


# ----------------------------------------------------------------------- volume filtering

@pytest.mark.parametrize("headwise", [False, True])
def test_disp_transformer_layer_matches_flax(headwise):
    """Over the disparity axis, and FastFoundationStereo's over the heads."""
    x = jnp.asarray(np.random.RandomState(3).randn(30, 13, 28).astype(np.float32))
    fm = jfsb.DispTransformerLayer(28, 4, 28, headwise=headwise)
    v = _module_variables(fm, (x,), 4)
    b = jw.FlaxToTorch(v)
    for f, t in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("out_proj", "out_proj")):
        b.dense(f, f"self_attn.{t}")
    for f, t in (("fc1", "linear1"), ("fc2", "linear2")):
        b.dense(f, t)
    for n in ("norm1", "norm2"):
        b.layer_norm(n, n)
    tm = tfsb.DispTransformerLayer(28, 4, 28, headwise=headwise)
    tm.load_state_dict(b.finish())
    with torch.inference_mode():
        got = tm(torch.from_numpy(np.array(x)))
    within_scale(got.numpy(), fm.apply(v, x), f"DispTransformerLayer headwise={headwise}")


def test_ahcf_hourglass_matches_flax(reference, port):
    """On flax's own gated volume and left features: the reduced 3D convs, the
    feature gates, the disparity transformer on the patchified volume and
    its trilinear ×4 resize."""
    _, _, _, inter = reference
    feats = [to_nchw(np.asarray(f)[:1]) for f in captured(inter, "feature")[0]]
    vol = torch.from_numpy(np.ascontiguousarray(np.moveaxis(
        np.asarray(captured(inter, "corr_feature_att")), -1, 1)))
    with torch.inference_mode():
        got = port.cost_agg(vol, feats)
    within_scale(np.moveaxis(got.numpy(), 1, -1), captured(inter, "cost_agg"), "AHCF hourglass")


# ----------------------------------------------------------------------- context and GRU

def test_context_net_dino_matches_flax(reference, port):
    _, data, _, inter = reference
    vit_l = to_nchw(np.asarray(captured(inter, "feature")[1])[:1])
    with torch.inference_mode():
        got = port.cnet(to_nchw(data["left"]), vit_l)
    for s, (gs, rs) in enumerate(zip(got, captured(inter, "cnet"))):
        for o, (g, r) in enumerate(zip(gs, rs)):
            within_scale(to_nhwc(g), r, f"ContextNetDino scale {s} output {o}")


def test_selective_conv_gru_matches_flax():
    rng = np.random.RandomState(5)
    att = jnp.asarray(1 / (1 + np.exp(-rng.randn(1, 6, 10, 1))), jnp.float32)
    h = jnp.asarray(np.tanh(rng.randn(1, 6, 10, 16)), jnp.float32)
    xs = [jnp.asarray(rng.randn(1, 6, 10, c).astype(np.float32)) for c in (16, 8)]
    fm = jfsb.SelectiveConvGRU(16)
    v = _module_variables(fm, (att, h, *xs), 6)
    b = jw.FlaxToTorch(v)
    for k in ("conv0", "conv1"):
        b.conv(k, f"{k}.0", raw=True)
    for g in ("small_gru", "large_gru"):
        for k in ("convz", "convr", "convq"):
            b.conv(f"{g}/{k}", f"{g}.{k}", raw=True)
    tm = tfsb.SelectiveConvGRU(16, 24)
    tm.load_state_dict(b.finish())
    with torch.inference_mode():
        got = tm(to_nchw(att), to_nchw(h), *(to_nchw(x) for x in xs))
    within_scale(to_nhwc(got), fm.apply(v, att, h, *xs), "SelectiveConvGRU")


def update_inputs(seed, sizes, cor_planes):
    """net, inp, att per GRU scale, the lookups and the disparity; NHWC."""
    rng = np.random.RandomState(seed)
    net = [np.tanh(rng.randn(1, h, w, 128)).astype(np.float32) for h, w in sizes]
    inp = [np.maximum(rng.randn(1, h, w, 128), 0).astype(np.float32) for h, w in sizes]
    att = [(1 / (1 + np.exp(-rng.randn(1, h, w, 1)))).astype(np.float32) for h, w in sizes]
    corr = rng.randn(1, *sizes[0], cor_planes).astype(np.float32)
    disp = rng.uniform(0, 8, (1, *sizes[0], 1)).astype(np.float32)
    return net, inp, corr, disp, att


def check_update_block(variables, block, n_gru, fuse, seed):
    """The selective cascade on its own with the model's variables: every
    returned hidden state, the mask features and the disparity update."""
    sizes = [(16, 24), (8, 12), (4, 6)][:n_gru]
    net, inp, corr, disp, att = update_inputs(seed, sizes, 522)
    params = variables["params"]["gru_loop"]["update_block"]
    fm = jfsb.BasicSelectiveMultiUpdateBlock(128, n_gru, fuse)
    rnet, rmask, rdelta = run_jitted_fast(lambda p, *a: fm.apply({"params": p}, *a), params,
                                          net, inp, corr, disp, att)
    c = lambda xs: [to_nchw(x) for x in xs]  # noqa: E731
    with torch.inference_mode():
        gnet, gmask, gdelta = block(c(net), c(inp), to_nchw(corr), to_nchw(disp), c(att))
    assert gmask.shape == (1, 32, 16, 24)
    within_scale(to_nhwc(gmask), rmask, "update block mask features")
    within_scale(to_nhwc(gdelta), rdelta, "update block disparity update")
    for i, (g, r) in enumerate(zip(gnet, rnet)):
        within_scale(to_nhwc(g), r, f"update block net[{i}]")


def test_update_block_matches_flax(reference, port):
    check_update_block(reference[0], port.update_block, 3, 3, 7)


# ----------------------------------------------------------------------- bf16 blocks

def bf16_bits(a) -> torch.Tensor:
    """A JAX bf16 array → a torch bf16 tensor of the same bits and layout."""
    return torch.from_numpy(np.array(np.asarray(a).view(np.int16))).view(torch.bfloat16)


def assert_rule_3a(got: torch.Tensor, ref, what, max_units=1.0):
    """Bit-equal but at most FLIP_SHARE of the elements, each by `max_units`
    (None: the share only)."""
    units = bf16_units(got.float().numpy(), np.asarray(ref, np.float32))
    share = float((units > 0).mean())
    print(f"{what}: {share:.3g} of {units.size} elements not bit-equal, max {units.max():.3g} "
          f"units")
    assert share <= FLIP_SHARE, what
    assert max_units is None or units.max() <= max_units, what


def test_gelu_and_xca_normalisation_bf16_bit_equal():
    """The two bf16 ops where the port follows JAX's roundings rather than
    PyTorch's own: `jax.nn.gelu`'s x·erfc(−x·√½)/2 op by op (torch's GELU,
    one rounding, is off by up to ~250 units at 38 % of these elements) and
    XCA's norm (the sum of f32 squares rounded, then its sqrt)."""
    x = jnp.asarray(np.random.RandomState(12).randn(4, 64, 96) * 2, jnp.bfloat16)
    assert torch.equal(gelu(bf16_bits(x)).view(torch.int16),
                       bf16_bits(jax.nn.gelu(x, approximate=False)).view(torch.int16))
    unit = x / jnp.maximum(jnp.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    assert torch.equal(tedge.l2_unit(bf16_bits(x), 1).view(torch.int16),
                       bf16_bits(unit).view(torch.int16))


def test_vit_block_bf16():
    """One vits block (384 wide, 6 heads, 65 tokens), flax op by op (3c); the
    whole block is held to the share of rule 3a only, as 3a's blocks whose
    norm feeds an activation: a one-unit flip of a Dense's product before its
    bias, or of a score before the softmax, moves a smaller sum by more units
    (up to 128 here)."""
    x = jnp.asarray(np.random.RandomState(8).randn(2, 65, 384), jnp.bfloat16)
    fm = jdino.ViTBlock(384, 6, dtype=jnp.bfloat16)
    v = _module_variables(fm, (x,), 9)
    b = jw.FlaxToTorch(v)
    jw.vit_block(b, "", "")
    tm = tdino.ViTBlock(384, 6)
    tm.load_state_dict(b.finish())
    with torch.inference_mode():
        got = tm.eval()(bf16_bits(x))
    assert_rule_3a(got, fm.apply(v, x), "ViT block bf16", max_units=None)


@pytest.mark.parametrize("kind", ["ConvEncoder", "SDTA"])
def test_edgenext_block_bf16(kind):
    """A stage-1 ConvEncoder (k 5) and its SDTA block with the Fourier
    position table, 96 wide, flax op by op (3c), held to the share only, as
    the ViT block."""
    x = jnp.asarray(np.random.RandomState(10).randn(1, 8, 12, 96), jnp.bfloat16)
    if kind == "ConvEncoder":
        fm, tm = jedge.ConvEncoder(96, 5, dtype=jnp.bfloat16), tedge.ConvEncoder(96, 5)
    else:
        fm = jedge.SDTAEncoder(96, scales=2, use_pos_emb=True, dtype=jnp.bfloat16)
        tm = tedge.SDTAEncoder(96, 2, use_pos_emb=True)
    v = _module_variables(fm, (x,), 11)
    b = jw.FlaxToTorch(v)
    jw.edgenext_block(b, "", "", kind == "ConvEncoder")
    tm.load_state_dict(b.finish())
    with torch.inference_mode():
        got = tm.eval()(bf16_bits(x).permute(0, 3, 1, 2))
    assert_rule_3a(got.permute(0, 2, 3, 1), fm.apply(v, x), f"EdgeNeXt {kind} bf16",
                   max_units=None)


# ----------------------------------------------------------------------- whole model

@pytest.mark.parametrize("kernels", [True, False])
def test_foundationstereo_matches_flax(reference, port, kernels):
    _, data, ref, _ = reference
    with torch.inference_mode():
        got = set_kernels(port, kernels)({k: to_nchw(v) for k, v in data.items()})[
            "disp_pred"].numpy()
    set_kernels(port, True)
    assert got.shape == ref.shape == (1, H, W)
    print(f"FoundationStereo port (kernels={kernels}) vs flax: max-abs "
          f"{np.abs(got - ref).max():.3g} px, disparity range {ref.min():.2f}..{ref.max():.2f}")
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4)


def test_foundationstereo_state_dict_round_trip_is_exact(reference, port):
    """port state_dict → the JAX package's converter → the flax variables."""
    back = convert_foundationstereo({k: v.numpy() for k, v in port.state_dict().items()})
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])  # noqa: E731
    a, b = flat(back), flat(reference[0])
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=str(k))


def test_load_pretrained_skips_the_reference_only_modules(port, tmp_path):
    """A reference checkpoint also holds modules the reference never runs
    (`convert_foundationstereo` drops them): `load_pretrained` skips them."""
    from openstereo_tpu_torch.tools.infer import load_pretrained

    sd = {k: v.clone() for k, v in port.state_dict().items()}
    extra = {"stem_4.0.conv.weight": torch.zeros(48, 32, 3, 3),
             "context_zqr_convs.0.weight": torch.zeros(384, 128, 3, 3),
             "cnet.down.0.weight": torch.zeros(128, 128, 3, 3), "cnet.norm.weight": torch.ones(128),
             "feature.dino.depth_anything.pretrained.mask_token": torch.zeros(1, 384),
             "feature.dino.depth_anything.depth_head.scratch.refinenet4.resConfUnit1.conv1.weight":
                 torch.zeros(64, 64, 3, 3)}
    torch.save({"model_state": {**sd, **extra}}, tmp_path / "fs.pth")
    model = FoundationStereo(**TINY)
    assert load_pretrained(model, str(tmp_path / "fs.pth")) == len(sd)
    assert all(torch.equal(model.state_dict()[k], v) for k, v in sd.items())


def test_build_model_runs_the_config_on_the_cpu_through_the_plain_k3(monkeypatch):
    """At full width (vitl, D/4 104, 371.7M parameters) on a 64×128 pair, the
    GRU loop cut to 2 iterations for time: a finite disparity, K3 once with
    divisor 1 (its plain version); a training forward (the config's 22
    iterations) gives the initial disparity and 22 iterates at the images'
    size through the plain cosine volume, not K3's wrapper; AANet, NMRF and
    IINet are still unported. The config has no
    EVALUATING transforms: the bench's `eval_size` falls back to 544×960."""
    calls = counted_plain_kernels(monkeypatch)
    cfg = load_config(str(CFG))
    assert "EVALUATING" not in cfg.DATA_CONFIG.DATA_TRANSFORM and eval_size(cfg) == (544, 960)
    model = build_model(cfg.MODEL, device="cpu", seed=0)
    assert isinstance(model, FoundationStereo) and not model.training
    assert (model.vit_size, model.max_disp // 4, model.valid_iters, model.n_gru_layers,
            model.corr_levels, model.corr_radius) == ("vitl", 104, 32, 3, 2, 4)
    assert sum(p.numel() for p in model.parameters()) > 300e6
    model.valid_iters = 2
    seen = []
    plain = gwc_volume_mod.gwc_volume_plain
    monkeypatch.setattr(gwc_volume_mod, "gwc_volume_plain",
                        lambda *a: seen.append(a[2:]) or plain(*a))
    x = torch.rand(1, 3, 64, 128, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        disp = model({"left": x, "right": x.roll(-3, dims=-1)})["disp_pred"]
    assert disp.shape == (1, 64, 128) and torch.isfinite(disp).all()
    assert seen == [(104, 8, 1)] and calls["mbconv"] == 0
    assert model.train_iters == 22
    with torch.no_grad():
        ts.check_training_outputs(model, {"left": x, "right": x.roll(-3, dims=-1)})
    assert seen == [(104, 8, 1)]
    for name in ("AANet", "NMRF", "IINet"):
        assert name in NOT_PORTED
        with pytest.raises(NotImplementedError):
            build_model(Config.from_dict({"NAME": name}), device="cpu")
