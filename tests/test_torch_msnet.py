"""Port MSNet3D and MSNet2D vs the flax models of the JAX package, eval, f32, on the CPU.

Small models (32×64 input, max_disp 16; MSNet3D with the config's 40
groups and hourglass width 32, MSNet2D with hourglass width 4 = D/4, since
its head resizes the classifier's channels to max_disp as an upsample) with
numpy-drawn flax variables of the training graph (so that `classif0`-
`classif2` exist, as the converters expect them); the weights go JAX →
port through `msnet3d_state_dict_from_jax` / `msnet2d_state_dict_from_jax`.
Each flax forward is jitted once per model and captures every submodule's
output, which the module tests feed to the port's modules. Tolerances as
`tests/test_torch_gwcnet.py`: the whole models atol 1e-3 px; modules rtol
1e-4 and atol 1e-5 times the largest output (random weights grow the
activations through 25 residual blocks). The JAX 3D convs run their
tap-merged CPU lowering: the same sums in another order. On the CPU the K2
and K3 wrappers run their plain versions, so "kernels on" checks their
wiring.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from openstereo_tpu.models.msnet import MSNet2D as FlaxMSNet2D
from openstereo_tpu.models.msnet import MSNet3D as FlaxMSNet3D
from openstereo_tpu.models.msnet.msnet import InterlacedCompressor as FlaxCompressor
from openstereo_tpu.utils.torch_convert import convert_msnet2d, convert_msnet3d

from openstereo_tpu_torch.config import load_config
from openstereo_tpu_torch.models import build_model, set_kernels
from openstereo_tpu_torch.models.layers import MobileV1Residual
from openstereo_tpu_torch.models.msnet import MSNet2D, MSNet3D
from openstereo_tpu_torch.models.msnet.msnet import (Hourglass, MobileFeatureTrunk,
                                                     compressor_layers, interlaced_compress)
from openstereo_tpu_torch.ops import kernels
from openstereo_tpu_torch.utils import jax_weights as jw

from test_torch_gwcnet import close_to_scale, to_ncdhw
from test_torch_layers import TOL, _random_variables
from test_torch_ops import to_nchw, to_nhwc
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
CFGS = {"MSNet3D": ROOT / "cfgs/msnet/msnet3d_sceneflow.yaml",
        "MSNet2D": ROOT / "cfgs/msnet/msnet2d_sceneflow.yaml"}
H, W, MAX_DISP = 32, 64, 16
TINY = {"MSNet3D": dict(max_disp=MAX_DISP), "MSNet2D": dict(max_disp=MAX_DISP, hg_size=4)}
FLAX = {"MSNet3D": FlaxMSNet3D, "MSNet2D": FlaxMSNet2D}
PORT = {"MSNet3D": MSNet3D, "MSNet2D": MSNet2D}
FROM_JAX = {"MSNet3D": jw.msnet3d_state_dict_from_jax, "MSNet2D": jw.msnet2d_state_dict_from_jax}
CONVERT = {"MSNet3D": convert_msnet3d, "MSNet2D": convert_msnet2d}


def _reference(name, seed):
    rng = np.random.RandomState(seed)
    data = {k: rng.randn(1, H, W, 3).astype(np.float32) for k in ("left", "right")}
    model = FLAX[name](**TINY[name])
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    variables = _random_variables(model, jdata, seed + 30, train=True)
    out, state = jax.jit(lambda v, b: model.apply(v, b, train=False, capture_intermediates=True,
                                                  mutable=["intermediates"]))(variables, jdata)
    return variables, data, np.asarray(out["disp_pred"]), state["intermediates"]


@pytest.fixture(scope="module")
def references():
    """name → (flax variables, NHWC inputs, flax disparity, captured outputs):
    one JAX compile per model."""
    return {"MSNet3D": _reference("MSNet3D", 0), "MSNet2D": _reference("MSNet2D", 1)}


def _port(name, variables, kernels=True):
    m = PORT[name](**TINY[name])
    m.load_state_dict(FROM_JAX[name](variables))
    return set_kernels(m.eval(), kernels)


def _run(model, data):
    with torch.inference_mode():
        return model({k: to_nchw(v) for k, v in data.items()})["disp_pred"].numpy()


def _sub(variables, name):
    return jw.FlaxToTorch({"params": variables["params"][name],
                           "batch_stats": variables["batch_stats"][name]})


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("name", ["MSNet3D", "MSNet2D"])
def test_msnet_matches_flax(references, name, kernels):
    variables, data, ref, _ = references[name]
    got = _run(_port(name, variables, kernels), data)
    assert got.shape == ref.shape == (1, H, W)
    print(f"{name} port (kernels={kernels}) vs flax: max-abs {np.abs(got - ref).max():.3g} px, "
          f"disparity range {ref.min():.2f}..{ref.max():.2f}")
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


@pytest.mark.parametrize("name", ["MSNet3D", "MSNet2D"])
def test_kernel_path_matches_eager_path(references, name):
    variables, data, _, _ = references[name]
    kernels.reset_launch_counts()
    wired = _run(_port(name, variables, True), data)
    eager = _run(_port(name, variables, False), data)
    assert sum(kernels.launch_counts.values()) == 0  # CPU tensors launch nothing
    print(f"{name} kernel path vs eager path (CPU): max-abs {np.abs(wired - eager).max():.3g} px")
    np.testing.assert_allclose(wired, eager, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", ["MSNet3D", "MSNet2D"], ids=["no relus", "add_relus"])
def test_mobile_feature_trunk_matches_flax(references, name):
    """The siamese 2B batch through the port's trunk, without (MSNet3D) and
    with (MSNet2D) the stem's ReLUs, vs the flax trunk's captured output."""
    variables, data, _, inter = references[name]
    b = _sub(variables, "trunk")
    jw.msnet_trunk(b, "", "", add_relus=name == "MSNet2D")
    port = MobileFeatureTrunk(add_relus=name == "MSNet2D")
    port.load_state_dict(b.finish())
    with torch.inference_mode():
        got = port.eval()(to_nchw(np.concatenate([data["left"], data["right"]])))
    assert got.shape == (2, 320, H // 4, W // 4)
    close_to_scale(to_nhwc(got), inter["trunk"]["__call__"][0], f"{name} trunk")


@pytest.mark.parametrize("layer,prev,what", [
    ("layer4_1", "layer4_0", "dilation 2"), ("layer2_0", "layer1_2", "stride 2, downsample"),
    ("layer3_0", "layer2_15", "downsample 64 -> 128")])
def test_mobilev1residual_matches_flax(references, layer, prev, what):
    """MobileV1Residual on the flax trunk's captured input of that block."""
    variables, _, _, inter = references["MSNet3D"]
    trunk = inter["trunk"]
    b = _sub(variables, "trunk")
    sub = jw.FlaxToTorch({c: b.trees[c][layer] for c in ("params", "batch_stats")})
    jw.msnet_mv1(sub, "", "")
    x = trunk[prev]["__call__"][0]
    cin, cout = x.shape[-1], trunk[layer]["__call__"][0].shape[-1]
    port = MobileV1Residual(cin, cout, 2 if layer == "layer2_0" else 1,
                            2 if layer.startswith("layer4") else 1)
    port.load_state_dict(sub.finish())
    with torch.inference_mode():
        got = port.eval()(to_nchw(x))
    close_to_scale(to_nhwc(got), trunk[layer]["__call__"][0], f"MobileV1Residual {what}")


@pytest.mark.parametrize("name,hg,prev", [("MSNet3D", "hg2", "hg1"), ("MSNet3D", "hg3", "hg2"),
                                          ("MSNet2D", "hg2", "hg1"), ("MSNet2D", "hg3", "hg2")])
def test_hourglass_matches_flax(references, name, hg, prev):
    """Hourglass3DMobile (MSNet3D) and Hourglass2D (MSNet2D) on the flax
    output of the hourglass before it."""
    variables, _, _, inter = references[name]
    b = _sub(variables, hg)
    jw.msnet_hourglass(b, "", "")
    ndim = 3 if name == "MSNet3D" else 2
    port = Hourglass(32 if ndim == 3 else 4, ndim)
    port.load_state_dict(b.finish())
    layout = to_ncdhw if ndim == 3 else to_nchw
    with torch.inference_mode():
        got = port.eval()(layout(inter[prev]["__call__"][0]))
    close_to_scale(to_nhwc(got), inter[hg]["__call__"][0], f"{name} {hg}")


def test_interlaced_compressor_matches_flax():
    """The compressor on an interleaved batch with per-row column validity
    (col >= d, as the model gives it), flax un-jitted; invalid columns are
    re-zeroed after every stage, so they stay zero through bias and BN."""
    rng = np.random.RandomState(8)
    n, h, w = 6, 5, 9
    x = rng.randn(n, h, w, 64).astype(np.float32)
    col_valid = np.arange(w)[None, :] >= np.array([0, 0, 1, 1, 4, 8])[:, None]
    fm = FlaxCompressor()
    v = _random_variables(fm, jnp.asarray(x), 9)
    b = jw.FlaxToTorch(v)
    jw.msnet_compressor(b, "", "")
    seqs = torch.nn.ModuleDict(compressor_layers())
    seqs.load_state_dict(b.finish())
    ref = np.asarray(fm.apply(v, jnp.asarray(x), jnp.asarray(col_valid), train=False))
    with torch.inference_mode():
        got = interlaced_compress(seqs["conv3d"].eval(), seqs["volume11"].eval(), to_nchw(x),
                                  torch.from_numpy(col_valid))
    assert got.shape == (n, h, w)
    print(f"InterlacedCompressor: max-abs {np.abs(got.numpy() - ref).max():.3g}")
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # without the mask the boundary columns differ: the mask is what the test holds
    with torch.inference_mode():
        unmasked = interlaced_compress(seqs["conv3d"], seqs["volume11"], to_nchw(x),
                                       torch.ones(n, w, dtype=torch.bool))
    assert np.abs(unmasked.numpy() - ref).max() > 1e-2


def test_msnet2d_interlaced_volume_matches_flax(references):
    """The whole interlaced volume (L/R interleave of the preconv outputs,
    all shifts in one batch, out-of-frame zeros) on the flax trunk's captured
    features, against the flax compressor's captured planes."""
    variables, _, _, inter = references["MSNet2D"]
    port = _port("MSNet2D", variables)
    feats = inter["trunk"]["__call__"][0]
    with torch.inference_mode():
        got = port.interlaced_volume(to_nchw(feats[:1]), to_nchw(feats[1:]))
    planes = np.asarray(inter["compressor"]["__call__"][0])  # [D/4·B, H/4, W/4]
    d4 = MAX_DISP // 4
    ref = np.where(np.arange(W // 4)[None, None, :] >= np.arange(d4)[:, None, None],
                   planes.reshape(d4, 1, H // 4, W // 4)[:, 0], 0.0)
    assert got.shape == (1, d4, H // 4, W // 4)
    close_to_scale(got[0].numpy(), ref, "MSNet2D interlaced volume")


@pytest.mark.parametrize("name", ["MSNet3D", "MSNet2D"])
def test_msnet_state_dict_round_trip_is_exact(references, name):
    """port state_dict → the JAX package's converter → the flax variables."""
    variables = references[name][0]
    back = CONVERT[name]({k: v.numpy() for k, v in _port(name, variables).state_dict().items()})
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])  # noqa: E731
    a, b = flat(back), flat(variables)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=str(k))


def test_build_model_reads_the_msnet_configs():
    m3 = build_model(load_config(str(CFGS["MSNet3D"])).MODEL, device="cpu", seed=0)
    assert isinstance(m3, MSNet3D) and not m3.training
    assert (m3.max_disp, m3.num_groups) == (192, 40)
    assert m3.dres0[0].conv[0].weight.shape == (120, 40, 1, 1, 1)
    m2 = build_model(load_config(str(CFGS["MSNet2D"])).MODEL, device="cpu", seed=0)
    assert isinstance(m2, MSNet2D) and m2.max_disp == 192
    assert m2.conv3d[0].weight.shape == (16, 1, 8, 3, 3) and m2.conv3d[0].bias is not None
    assert m2.dres0[0].conv[0].weight.shape == (144, 48, 1, 1)
    assert m2.encoder_decoder1.conv4.conv[6].weight.shape == (192, 384, 1, 1)
    for name, model in (("MSNet3D", m3), ("MSNet2D", m2)):
        ref = CONVERT[name]({k: v.numpy() for k, v in model.state_dict().items()})
        assert set(ref["params"]) >= {"trunk", "dres0a", "hg3", "classif0a", "classif3b"}


@pytest.mark.parametrize("name", ["MSNet3D", "MSNet2D"])
def test_infer_cli_on_cpu_with_the_msnet_configs(tmp_path, name):
    """Each MSNet config's transforms and MODEL section, cut to max_disp 16
    (MSNet2D hourglass width 4) and a 32×64 pad so that the CPU run stays
    short."""
    from PIL import Image

    from openstereo_tpu_torch.tools import infer

    cfg = yaml.safe_load(CFGS[name].read_text())
    cfg["MODEL"].update({k.upper(): v for k, v in TINY[name].items()})
    cfg["DATA_CONFIG"]["DATA_TRANSFORM"]["EVALUATING"][0]["SIZE"] = [H, W]
    (tmp_path / "msnet.yaml").write_text(yaml.safe_dump(cfg))
    img = (np.random.RandomState(15).rand(30, 60, 3) * 255).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "left.png")
    Image.fromarray(np.roll(img, -3, axis=1)).save(tmp_path / "right.png")
    out = tmp_path / "disp.png"
    disp = infer.main(["--cfg_file", str(tmp_path / "msnet.yaml"),
                       "--left_img_path", str(tmp_path / "left.png"),
                       "--right_img_path", str(tmp_path / "right.png"),
                       "--out", str(out), "--device", "cpu"])
    assert disp.shape == (H, W) and np.isfinite(disp).all()
    assert 0 <= disp.min() and disp.max() <= MAX_DISP
    png = np.asarray(Image.open(out))
    assert png.shape == (H, W) and png.dtype == np.uint16
