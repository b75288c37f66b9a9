"""Port FADNet vs the flax FADNet of the JAX package, eval, f32, on the CPU.

A small model (64×192 input, max_disp 64, so the correlation volume has
D 64/8 + 16 = 24; encoder ratio 2 and decoder ratio 4, an eighth and a
quarter of the config's widths, 2.9M parameters in place of 124M; at
encoder ratio 4 the DyRes block's input would match its width and lose the
shortcut that the reference always has) with numpy-drawn
flax variables in the tree that `convert_fadnet` makes of the port's
state_dict; the weights go JAX → port through `fadnet_state_dict_from_jax`.
The flax forward is jitted once (`run_jitted_fast`) and captures the
outputs of the submodules that the module tests feed to the port's
modules. Modules are held as `tests/test_torch_gwcnet.py` holds them
(rtol 1e-4, atol 1e-5 of the largest output), the whole model at 1e-3 px.
On the CPU the K1 wrapper runs its plain version, so "kernels on" checks
the wiring of K1.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from openstereo_tpu.models.fadnet import FADNet as FlaxFADNet
from openstereo_tpu.utils.torch_convert import convert_fadnet

from openstereo_tpu_torch.config import load_config
from openstereo_tpu_torch.models import build_model, set_kernels
from openstereo_tpu_torch.models.fadnet import FADNet
from openstereo_tpu_torch.models.fadnet.fadnet import FadResBlock, _leaky
from openstereo_tpu_torch.ops import corr_volume
from openstereo_tpu_torch.utils import jax_weights as jw

from test_torch_gwcnet import close_to_scale
from test_torch_layers import _random_variables_via, run_jitted_fast
from test_torch_ops import to_nchw
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
CFG = ROOT / "cfgs/fadnet/fadnet_sceneflow.yaml"
H, W = 64, 192
TINY = dict(max_disp=64, encoder_ratio=2, decoder_ratio=4)
CAPTURED = {"conv3", "conv_redir", "conv3_1", "enc456", "decoder_c", "res_conv3",
            "res_conv3_1"}


@pytest.fixture(scope="module")
def reference():
    """(flax variables, NHWC inputs, flax disparity, captured module outputs):
    the module's one JAX compile."""
    rng = np.random.RandomState(0)
    data = {k: rng.randn(1, H, W, 3).astype(np.float32) for k in ("left", "right")}
    variables = _random_variables_via(convert_fadnet, FADNet(**TINY), 31)
    model = FlaxFADNet(**TINY)
    out, state = run_jitted_fast(lambda v, b: model.apply(
        v, b, train=False, capture_intermediates=lambda m, _: m.name in CAPTURED,
        mutable=["intermediates"]), variables, {k: jnp.asarray(v) for k, v in data.items()})
    return variables, data, np.asarray(out["disp_pred"]), state["intermediates"]


@pytest.fixture(scope="module")
def ports(reference):
    """kernels on/off → the port's disparity, and "model": the port model."""
    variables, data = reference[:2]
    model = FADNet(**TINY)
    model.load_state_dict(jw.fadnet_state_dict_from_jax(variables))
    model.eval()
    out = {"model": model}
    for k in (True, False):
        with torch.inference_mode():
            out[k] = set_kernels(model, k)({n: to_nchw(v) for n, v in data.items()})[
                "disp_pred"].numpy()
    return out


@pytest.mark.parametrize("kernels", [True, False])
def test_fadnet_matches_flax(reference, ports, kernels):
    ref, got = reference[2], ports[kernels]
    assert got.shape == ref.shape == (1, H, W)
    print(f"FADNet port (kernels={kernels}) vs flax: max-abs {np.abs(got - ref).max():.3g} px, "
          f"disparity range {ref.min():.2f}..{ref.max():.2f}")
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


def test_kernel_path_matches_eager_path(ports):
    print(f"FADNet kernel path vs eager path (CPU): max-abs "
          f"{np.abs(ports[True] - ports[False]).max():.3g} px")
    np.testing.assert_allclose(ports[True], ports[False], rtol=0, atol=1e-4)


def _captured(inter, name):
    return inter[name]["__call__"][0]


@pytest.mark.parametrize("name,prev,shape,dyres", [
    ("res_conv3_1", "res_conv3", (16, 16, 1), False),   # identity skip
    ("conv_redir", "conv3", (16, 4, 1), False),          # 1×1 shortcut, biased
])
def test_fad_res_block_matches_flax(reference, name, prev, shape, dyres):
    variables, _, _, inter = reference
    b = jw.FlaxToTorch({"params": variables["params"][name],
                        "batch_stats": variables["batch_stats"][name]})
    jw.fad_res(b, "", "", dyres=dyres)
    port = FadResBlock(*shape, dyres=dyres)
    port.load_state_dict(b.finish())
    x = _captured(inter, prev)
    if name == "conv_redir":
        x = x[:1]  # the redirect runs on the left view's features
    with torch.inference_mode():
        got = port.eval()(to_nchw(x))
    close_to_scale(np.moveaxis(got.numpy(), 1, -1), _captured(inter, name), f"FadResBlock {name}")


def test_dyres_block_and_stage1_decoder_match_flax(reference, ports):
    """The DyRes `conv3_1` (bias-free conv1 and shortcut, K1's volume beside
    the redirected features), then Encoder456 and the DispNetC pyramid of
    the port on flax's inputs: the seven flows."""
    variables, data, _, inter = reference
    cp = ports["model"].cost_processor
    left = _captured(inter, "conv3")[:1]
    right = _captured(inter, "conv3")[1:]
    with torch.inference_mode():
        vol = _leaky(corr_volume(to_nchw(left), to_nchw(right), ports["model"].corr_disp))
        conv3b = cp.conv3_1(torch.cat([to_nchw(_captured(inter, "conv_redir")), vol], 1))
        close_to_scale(np.moveaxis(conv3b.numpy(), 1, -1), _captured(inter, "conv3_1"),
                       "DyRes conv3_1")
        c4, c5, c6 = cp.encode456(to_nchw(_captured(inter, "conv3_1")))
        enc = _captured(inter, "enc456")
        for got, ref, lvl in zip((c4, c5, c6), enc, (4, 5, 6)):
            close_to_scale(np.moveaxis(got.numpy(), 1, -1), ref, f"Encoder456 conv{lvl}_1")
        skips = [to_nchw(a) for a in (enc[2], enc[1], enc[0], _captured(inter, "conv3_1"))]
        # conv2 and conv1 of the left view, through the port's own backbone
        c1, c2, _ = ports["model"].backbone(to_nchw(data["left"]))
        flows = cp.decode(skips + [c2, c1, to_nchw(data["left"])])
    for lvl, (got, ref) in enumerate(zip(flows, _captured(inter, "decoder_c"))):
        close_to_scale(np.moveaxis(got.numpy(), 1, -1), ref, f"DispNetC flow {lvl}")


def test_warp_inputs_match_flax(reference, ports):
    """The stage-2 input: the warp with the reference's coordinate quirk on
    flax's own full-resolution flow, which reaches past both edges."""
    from openstereo_tpu.ops.sampler import bilinear_sampler

    _, data, _, inter = reference
    flow = np.asarray(_captured(inter, "decoder_c")[0])  # [1,H,W,1]
    left, right = data["left"], data["right"]
    xs = np.arange(W, dtype=np.float32)[None, None, :]
    ys = np.arange(H, dtype=np.float32)[None, :, None]
    src = np.stack([(xs - flow[..., 0]) * (W / (W - 1)) - 0.5,
                    np.broadcast_to(ys * (H / (H - 1)) - 0.5, (1, H, W))], -1)
    assert src[..., 0].min() < -1 and src[..., 0].max() > W - 1, "the warp stays in frame"
    warped = np.asarray(jax.jit(bilinear_sampler)(right, src.astype(np.float32)))
    diff = left - warped
    ref = np.concatenate([left, right, warped, flow,
                          np.sqrt((diff * diff).sum(-1, keepdims=True) + 1e-8)], -1)
    with torch.inference_mode():
        got = ports["model"].warp_inputs(to_nchw(left), to_nchw(right), to_nchw(flow))
    assert got.shape == (1, 11, H, W)
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), ref, rtol=1e-5, atol=1e-5)


def test_fadnet_state_dict_round_trip_is_exact(reference, ports):
    """port state_dict → the JAX package's converter → the flax variables."""
    variables = reference[0]
    back = convert_fadnet({k: v.numpy() for k, v in ports["model"].state_dict().items()},
                          max_disp=TINY["max_disp"])
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])  # noqa: E731
    a, b = flat(back), flat(variables)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=str(k))


def test_dynamic_conv_loads_a_max_range_weight():
    """A reference checkpoint sizes DyRes weights for MAX_RANGE 400 (98 input
    channels at 1/8 + 16 + 32): loading slices them to the model's input."""
    port = FadResBlock(72, 128, dyres=True)
    sd = port.state_dict()
    wide = {k: (torch.randn(128, 98, *v.shape[2:]) if k.endswith("conv.weight") else v)
            for k, v in sd.items()}
    port.load_state_dict(wide)
    assert torch.equal(port.conv1.conv.weight, wide["conv1.conv.weight"][:, :72])
    assert torch.equal(port.shortcut[0].conv.weight, wide["shortcut.0.conv.weight"][:, :72])


def test_build_model_reads_the_fadnet_config():
    cfg = load_config(str(CFG))
    model = build_model(cfg.MODEL, device="cpu", seed=0)
    assert isinstance(model, FADNet) and not model.training
    assert model.corr_disp == 40
    assert model.cost_processor.conv3_1.conv1.conv.weight.shape == (128, 72, 3, 3)
    assert model.cost_processor.iconv0.weight.shape == (36, 32, 3, 3)
    assert model.disp_predictor.conv1[0].weight.shape == (32, 11, 7, 7)


def test_infer_cli_on_cpu_with_the_fadnet_config(tmp_path):
    """The FADNet config's transforms and MODEL section, cut to max_disp 64,
    the test's ratios and a 64×192 pad so that the CPU run stays short."""
    from PIL import Image

    from openstereo_tpu_torch.tools import infer

    cfg = yaml.safe_load(CFG.read_text())
    cfg["MODEL"].update({k.upper(): v for k, v in TINY.items()})
    cfg["DATA_CONFIG"]["DATA_TRANSFORM"]["EVALUATING"][0]["SIZE"] = [H, W]
    (tmp_path / "fadnet.yaml").write_text(yaml.safe_dump(cfg))
    img = (np.random.RandomState(15).rand(60, 180, 3) * 255).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "left.png")
    Image.fromarray(np.roll(img, -3, axis=1)).save(tmp_path / "right.png")
    out = tmp_path / "disp.png"
    disp = infer.main(["--cfg_file", str(tmp_path / "fadnet.yaml"),
                       "--left_img_path", str(tmp_path / "left.png"),
                       "--right_img_path", str(tmp_path / "right.png"),
                       "--out", str(out), "--device", "cpu"])
    assert disp.shape == (H, W) and np.isfinite(disp).all() and disp.min() >= 0
    png = np.asarray(Image.open(out))
    assert png.shape == (H, W) and png.dtype == np.uint16
