"""Port CFNet vs the flax CFNet of the JAX package, eval, f32, on the CPU.

A small model (64×128 input, max_disp 64, the config's 40 groups and 12
concat channels, so the 1/32 volume has D 2) with numpy-drawn flax
variables of the training graph, in the tree that `convert_cfnet` makes of
the port's state_dict; the weights go JAX → port through
`cfnet_state_dict_from_jax`. The flax forward is jitted once (at XLA:CPU's
optimisation level 0, `run_jitted_fast`) and captures
the outputs of the submodules that the module tests feed to the port's
modules (its 3D convs in the "native" lowering that the port follows,
ROADMAP 3d), and (through a `jax.debug.callback` on `warped_volumes`, patched
for the fixture only) the two sample grids. Modules are held as
`tests/test_torch_gwcnet.py` holds them (rtol 1e-4, atol 1e-5 of the
largest output). The whole model: its sample grids are floors and ceils of
f32 values after an align-corners resize, and two sum orders may move a
value across an integer, so the grids are compared first, entry by entry
(at most 1e-3 of the entries may differ, each by exactly 1); with equal
grids the disparity is held at 1e-3 px everywhere, else at the pixels
whose 1/2-scale samples agree. On the CPU the K3 wrapper runs its plain
version, so "kernels on" checks the wiring of K3.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

import openstereo_tpu.models.cfnet.cfnet as jcfnet
from openstereo_tpu.utils.torch_convert import convert_cfnet

from openstereo_tpu_torch.config import load_config
from openstereo_tpu_torch.models import build_model, set_kernels
from openstereo_tpu_torch.models.cfnet import CFNet
from openstereo_tpu_torch.models.cfnet.cfnet import (HourglassUp, Mish, mish, mish_res_block,
                                                     warped_volumes)
from openstereo_tpu_torch.models.gwcnet.gwcnet import GwcHourglass
from openstereo_tpu_torch.utils import jax_weights as jw

from test_torch_gwcnet import close_to_scale, to_ncdhw
from test_torch_layers import _random_variables_via, run_jitted_fast
from test_torch_ops import to_nchw
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
CFG = ROOT / "cfgs/cfnet/cfnet_sceneflow.yaml"
H, W = 64, 128
TINY = dict(max_disp=64)
SAMPLE_FLIP_SHARE = 1e-3
# the flax submodules whose outputs the module tests read
CAPTURED = {"features", "layer3", "layer4", "dres4_0b", "dres4_1b", "dres5_0b", "dres5_1b",
            "dres6_0b", "dres6_1b", "combine1", "dres3", "conf2_s2", "conf3_s2"}


def _sub(variables, name):
    return jw.FlaxToTorch({"params": variables["params"][name],
                           "batch_stats": variables["batch_stats"][name]})


@pytest.fixture(scope="module")
def reference():
    """(flax variables, NHWC inputs, flax disparity, captured module outputs,
    the flax sample grids [s3, s2]): the module's one JAX compile."""
    rng = np.random.RandomState(0)
    data = {k: rng.randn(1, H, W, 3).astype(np.float32) for k in ("left", "right")}
    variables = _random_variables_via(convert_cfnet, CFNet(**TINY), 21)
    grids = []
    original = jcfnet.warped_volumes

    def recording(gw_l, gw_r, cat_l, cat_r, samples, num_groups):
        jax.debug.callback(lambda s: grids.append(np.asarray(s)), samples)
        return original(gw_l, gw_r, cat_l, cat_r, samples, num_groups)

    model = jcfnet.CFNet(**TINY)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcfnet, "warped_volumes", recording)
        for var in ("OPENSTEREO_CONV3D", "OPENSTEREO_DECONV3D"):
            mp.setenv(var, "native")
        out, state = run_jitted_fast(lambda v, b: model.apply(
            v, b, train=False, capture_intermediates=lambda m, _: m.name in CAPTURED,
            mutable=["intermediates"]), variables, {k: jnp.asarray(v) for k, v in data.items()})
        ref = np.asarray(out["disp_pred"])
    assert len(grids) == 2
    return variables, data, ref, state["intermediates"], grids


@pytest.fixture(scope="module")
def ports(reference):
    """kernels on/off → (port disparity, its two sample grids), and "model":
    the port model with the flax weights."""
    variables, data = reference[:2]
    model = _port(variables)
    out = {k: _run(set_kernels(model, k), data) for k in (True, False)}
    out["model"] = model
    return out


def _port(variables, kernels=True):
    m = CFNet(**TINY)
    m.load_state_dict(jw.cfnet_state_dict_from_jax(variables))
    return set_kernels(m.eval(), kernels)


def _run(model, data):
    """The port's disparity and its two sample grids, on the pair stacked
    twice: from batch 2 on, PyTorch's CPU 3D convs take oneDNN in place of
    their slow batch-1 path (a forward in 0.6 s, not 1.0), and both batch
    entries are held against flax's one."""
    grids = []
    inner = model._range_and_samples
    model._range_and_samples = lambda *a: grids.append(inner(*a)) or grids[-1]
    try:
        with torch.inference_mode():
            disp = model({k: to_nchw(np.concatenate([v, v])) for k, v in data.items()})[
                "disp_pred"].numpy()
    finally:
        del model._range_and_samples
    return disp, [g.numpy() for g in grids]


@pytest.mark.parametrize("kernels", [True, False])
def test_cfnet_matches_flax(reference, ports, kernels):
    ref, ref_grids = reference[2], reference[4]
    got, grids = ports[kernels]
    assert got.shape == (2, H, W) and ref.shape == (1, H, W)
    for name, g, rg in zip(("1/4", "1/2"), grids, ref_grids):
        assert g.shape[1:] == rg.shape[1:] and len(g) == 2
        diff = np.abs(g - rg)
        share = float((diff > 0).mean())
        print(f"CFNet {name} sample grid {g.shape}: {share:.3g} of the entries differ")
        assert share <= SAMPLE_FLIP_SHARE and np.all((diff == 0) | (diff == 1)), name
    agree = (grids[1] == ref_grids[1]).all(axis=1)  # [2,H/2,W/2]
    agree = np.repeat(np.repeat(agree, 2, axis=1), 2, axis=2)
    ref = np.broadcast_to(ref, got.shape)
    err = np.abs(got - ref)
    print(f"CFNet port (kernels={kernels}) vs flax: max-abs {err.max():.3g} px, "
          f"{agree.mean():.4f} of the pixels with equal samples, disparity range "
          f"{ref.min():.2f}..{ref.max():.2f}")
    np.testing.assert_allclose(got[agree], ref[agree], rtol=0, atol=1e-3)


def test_kernel_path_matches_eager_path(ports):
    wired, eager = ports[True][0], ports[False][0]
    print(f"CFNet kernel path vs eager path (CPU): max-abs {np.abs(wired - eager).max():.3g} px")
    np.testing.assert_allclose(wired, eager, rtol=0, atol=1e-4)


def test_mish_matches_jax():
    x = np.random.RandomState(5).randn(4, 300).astype(np.float32) * 6
    x[0, :4] = [-30.0, 0.0, 25.0, -1e-3]
    ref = np.asarray(jcfnet.mish(jnp.asarray(x)))
    np.testing.assert_allclose(mish(torch.from_numpy(x)).numpy(), ref, rtol=1e-6, atol=1e-7)


def test_cf_features_match_flax(reference, ports):
    """The siamese 2B batch through the port's CFFeatures (PSP windows at the
    1/32 scale of 2×4, the decoder and all ten heads) vs flax's."""
    _, data, _, inter, _ = reference
    port = ports["model"].feature_extraction
    x = np.concatenate([data["left"], data["right"]])
    with torch.inference_mode():
        got = port.eval()(to_nchw(x))
    ref = inter["features"]["__call__"][0]
    assert set(got) == set(ref)
    for key in sorted(ref):
        close_to_scale(np.moveaxis(got[key].numpy(), 1, -1), ref[key], f"CFFeatures {key}")


def test_mish_res_block_matches_flax(reference):
    """`layer4` (stride 2, 128 → 192) on flax's `layer3` output."""
    variables, _, _, inter, _ = reference
    b = _sub(variables, "features")
    jw.res_block(b, "layer4", "0", nested=True)
    port = mish_res_block(128, 192, 2, Mish())
    port.load_state_dict(b.sd)
    feats = inter["features"]
    with torch.inference_mode():
        got = port.eval()(to_nchw(feats["layer3"]["__call__"][0]))
    close_to_scale(np.moveaxis(got.numpy(), 1, -1), feats["layer4"]["__call__"][0],
                   "MishResBlock layer4")


def _cost0(inter, name):
    """dres output r + v from the captured `{name}_1b` and `{name}_0b`."""
    return to_ncdhw(np.asarray(inter[f"{name}_1b"]["__call__"][0])
                    + np.asarray(inter[f"{name}_0b"]["__call__"][0]))


def test_hourglass_up_matches_flax(reference):
    """`combine1` on the captured fused-stage volumes at 1/8, 1/16, 1/32."""
    variables, _, _, inter, _ = reference
    full = jw.cfnet_state_dict_from_jax(variables)
    port = HourglassUp(32, Mish())
    port.load_state_dict({k[len("combine1."):]: v for k, v in full.items()
                          if k.startswith("combine1.")})
    with torch.inference_mode():
        got = port.eval()(_cost0(inter, "dres4"), _cost0(inter, "dres5"), _cost0(inter, "dres6"))
    close_to_scale(np.moveaxis(got.numpy(), 1, -1), inter["combine1"]["__call__"][0],
                   "HourglassUp combine1")


@pytest.mark.parametrize("name,prev,c", [("dres3", "combine1", 32), ("conf3_s2", "conf2_s2", 16)])
def test_mish_hourglass_matches_flax(reference, name, prev, c):
    variables, _, _, inter, _ = reference
    b = _sub(variables, name)
    jw.gwc_hourglass(b, "", "")
    port = GwcHourglass(c, Mish())
    port.load_state_dict(b.finish())
    with torch.inference_mode():
        got = port.eval()(to_ncdhw(inter[prev]["__call__"][0]))
    close_to_scale(np.moveaxis(got.numpy(), 1, -1), inter[name]["__call__"][0],
                   f"MishHourglass {name}")


def test_warped_volumes_match_jax(reference):
    """The 1/4-scale warped volume on the captured features and the flax
    sample grid, against `warped_volumes` (jitted: f32)."""
    _, _, _, inter, grids = reference
    feats = inter["features"]["__call__"][0]
    args = [np.asarray(feats[k]) for k in ("gw3", "gw3", "concat_feature3", "concat_feature3")]
    left = [a[:1] for a in args[0::2]]
    right = [a[1:] for a in args[1::2]]
    samples = np.array(grids[0])
    ref = np.asarray(jax.jit(jcfnet.warped_volumes, static_argnums=5)(
        left[0], right[0], left[1], right[1], samples, 40))
    got = warped_volumes(to_nchw(left[0]), to_nchw(right[0]), to_nchw(left[1]),
                         to_nchw(right[1]), torch.from_numpy(samples), 40)
    assert got.shape == (1, 40 + 24 + 1) + samples.shape[1:]
    close_to_scale(np.moveaxis(got.numpy(), 1, -1), ref, "warped_volumes 1/4")


def test_cfnet_state_dict_round_trip_is_exact(reference, ports):
    """port state_dict → the JAX package's converter → the flax variables."""
    variables = reference[0]
    back = convert_cfnet({k: v.numpy() for k, v in ports["model"].state_dict().items()})
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])  # noqa: E731
    a, b = flat(back), flat(variables)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=str(k))


def test_build_model_reads_the_cfnet_config():
    cfg = load_config(str(CFG))
    model = build_model(cfg.MODEL, device="cpu", seed=0)
    assert isinstance(model, CFNet) and not model.training
    assert (model.max_disp, model.num_groups, model.sample_count_s3,
            model.sample_count_s2) == (192, 40, 14, 10)
    assert model.confidence0_s3[0][0].weight.shape == (32, 65, 3, 3, 3)
    assert model.confidence0_s2[0][0].weight.shape == (16, 33, 3, 3, 3)
    assert all(0 < abs(p.item()) <= 0.1 for p in (model.gamma_s3, model.beta_s2))


def test_infer_cli_on_cpu_with_the_cfnet_config(tmp_path):
    """The CFNet config's transforms and MODEL section, cut to max_disp 64 and
    a 64×128 pad so that the CPU run stays short."""
    from PIL import Image

    from openstereo_tpu_torch.tools import infer

    cfg = yaml.safe_load(CFG.read_text())
    cfg["MODEL"].update({k.upper(): v for k, v in TINY.items()})
    cfg["DATA_CONFIG"]["DATA_TRANSFORM"]["EVALUATING"][0]["SIZE"] = [H, W]
    (tmp_path / "cfnet.yaml").write_text(yaml.safe_dump(cfg))
    img = (np.random.RandomState(15).rand(60, 120, 3) * 255).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "left.png")
    Image.fromarray(np.roll(img, -3, axis=1)).save(tmp_path / "right.png")
    out = tmp_path / "disp.png"
    disp = infer.main(["--cfg_file", str(tmp_path / "cfnet.yaml"),
                       "--left_img_path", str(tmp_path / "left.png"),
                       "--right_img_path", str(tmp_path / "right.png"),
                       "--out", str(out), "--device", "cpu"])
    assert disp.shape == (H, W) and np.isfinite(disp).all()
    assert 0 <= disp.min() and disp.max() <= TINY["max_disp"]
    png = np.asarray(Image.open(out))
    assert png.shape == (H, W) and png.dtype == np.uint16
