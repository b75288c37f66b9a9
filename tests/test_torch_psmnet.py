"""Port PSMNet vs the flax PSMNet of the JAX package, eval, f32, on the CPU.

A tiny model (32×64 input, max_disp 16; the backbone and aggregator keep
their full widths) with numpy-drawn flax variables; the weights go JAX →
port through `psmnet_state_dict_from_jax`. The flax forward is jitted once
per module and captures every submodule's output, which the module tests
feed to the port's SPPBackbone and Hourglass3D. Tolerances as
`tests/test_torch_gwcnet.py`: modules rtol 1e-4 and atol 1e-5 times the
largest output (random weights grow the activations), the whole model
atol 1e-3 px. PSMNet has no kernel of the port on its path.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from openstereo_tpu.models.psmnet import PSMNet as FlaxPSMNet
from openstereo_tpu.utils.torch_convert import convert_psmnet

from openstereo_tpu_torch.config import load_config
from openstereo_tpu_torch.models import build_model
from openstereo_tpu_torch.models.psmnet import PSMNet
from openstereo_tpu_torch.models.psmnet.psmnet import Hourglass3D, SPPBackbone
from openstereo_tpu_torch.ops import kernels
from openstereo_tpu_torch.utils import jax_weights as jw

from test_torch_gwcnet import close_to_scale, to_ncdhw
from test_torch_layers import _random_variables
from test_torch_ops import to_nchw

ROOT = Path(__file__).resolve().parents[1]
CFG = ROOT / "cfgs/psmnet/psmnet_sceneflow.yaml"
H, W, MAX_DISP = 32, 64, 16


@pytest.fixture(scope="module")
def reference():
    """(flax variables, NHWC inputs, flax disparity, captured module outputs):
    the module's one JAX compile."""
    rng = np.random.RandomState(1)
    data = {k: rng.randn(1, H, W, 3).astype(np.float32) for k in ("left", "right")}
    model = FlaxPSMNet(max_disp=MAX_DISP)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    variables = _random_variables(model, jdata, 12)
    out, state = jax.jit(lambda v, b: model.apply(v, b, train=False, capture_intermediates=True,
                                                  mutable=["intermediates"]))(variables, jdata)
    return variables, data, np.asarray(out["disp_pred"]), state["intermediates"]


def _port(variables):
    m = PSMNet(max_disp=MAX_DISP)
    m.load_state_dict(jw.psmnet_state_dict_from_jax(variables))
    return m.eval()


def _sub(variables, name):
    return jw.FlaxToTorch({"params": variables["params"][name],
                           "batch_stats": variables["batch_stats"][name]})


def test_psmnet_matches_flax(reference):
    variables, data, ref, _ = reference
    kernels.reset_launch_counts()
    with torch.inference_mode():
        got = _port(variables)({k: to_nchw(v) for k, v in data.items()})["disp_pred"].numpy()
    assert got.shape == ref.shape == (1, H, W)
    assert not any(kernels.launch_counts.values())
    print(f"PSMNet port vs flax: max-abs {np.abs(got - ref).max():.3g} px, "
          f"disparity range {ref.min():.2f}..{ref.max():.2f}")
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


def test_spp_backbone_matches_flax(reference):
    """The siamese 2B batch through the port's SPPBackbone (the pool windows
    clamped at this size) vs the flax backbone's captured output."""
    variables, data, _, inter = reference
    b = _sub(variables, "backbone")
    jw.spp_backbone(b, "", "")
    port = SPPBackbone()
    port.load_state_dict(b.finish())
    with torch.inference_mode():
        got = port.eval()(to_nchw(np.concatenate([data["left"], data["right"]])))
    assert got.shape == (2, 32, H // 4, W // 4)
    close_to_scale(np.moveaxis(got.numpy(), 1, -1), inter["backbone"]["__call__"][0],
                   "SPPBackbone")


def test_hourglass3d_matches_flax(reference):
    """dres2 on cost0 and dres3 on (out1, pre1, post1), both rebuilt from the
    captured flax outputs with the same f32 adds as the flax model."""
    variables, _, _, inter = reference
    out = lambda name: np.asarray(inter[name]["__call__"][0])  # noqa: E731
    cost0 = out("dres1b") + out("dres0b")
    out1, pre1, post1 = (np.asarray(t) for t in inter["dres2"]["__call__"][0])
    for name, args in (("dres2", (cost0,)), ("dres3", (out1 + cost0, pre1, post1))):
        b = _sub(variables, name)
        jw.psm_hourglass(b, "", "")
        port = Hourglass3D(32)
        port.load_state_dict(b.finish())
        with torch.inference_mode():
            got = port.eval()(*[to_ncdhw(a) for a in args])
        for tag, g, r in zip(("out", "pre", "post"), got, inter[name]["__call__"][0]):
            close_to_scale(np.moveaxis(g.numpy(), 1, -1), r, f"Hourglass3D {name} {tag}")


def test_psmnet_state_dict_round_trip_is_exact(reference):
    """port state_dict → the JAX package's converter → the flax variables."""
    variables = reference[0]
    back = convert_psmnet({k: v.numpy() for k, v in _port(variables).state_dict().items()})
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])  # noqa: E731
    a, b = flat(back), flat(variables)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=str(k))


def test_build_model_reads_the_psmnet_config():
    cfg = load_config(str(CFG))
    model = build_model(cfg.MODEL, device="cpu", seed=0)
    assert isinstance(model, PSMNet) and not model.training and model.max_disp == 192
    agg = model.CostProcessor["aggregator"]
    assert agg.dres0[0][0].weight.shape == (32, 64, 3, 3, 3)
    assert agg.dres2.conv5[0].weight.shape == (64, 64, 3, 3, 3)
    assert [model.Backbone.branch1[0].kernel_size, model.Backbone.branch4[0].kernel_size] == [64, 8]
    ref = convert_psmnet({k: v.numpy() for k, v in model.state_dict().items()})
    assert set(ref["params"]) >= {"backbone", "dres0a", "dres4", "classif1a", "classif3b"}


def test_infer_cli_on_cpu_with_the_psmnet_config(tmp_path):
    """The PSMNet config's transforms and MODEL section, cut to max_disp 16
    and a 32×64 pad so that the CPU run stays short."""
    from PIL import Image

    from openstereo_tpu_torch.tools import infer

    cfg = yaml.safe_load(CFG.read_text())
    cfg["MODEL"]["MAX_DISP"] = MAX_DISP
    cfg["DATA_CONFIG"]["DATA_TRANSFORM"]["EVALUATING"][0]["SIZE"] = [H, W]
    (tmp_path / "psmnet.yaml").write_text(yaml.safe_dump(cfg))
    img = (np.random.RandomState(16).rand(30, 60, 3) * 255).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "left.png")
    Image.fromarray(np.roll(img, -3, axis=1)).save(tmp_path / "right.png")
    out = tmp_path / "disp.png"
    disp = infer.main(["--cfg_file", str(tmp_path / "psmnet.yaml"),
                       "--left_img_path", str(tmp_path / "left.png"),
                       "--right_img_path", str(tmp_path / "right.png"),
                       "--out", str(out), "--device", "cpu"])
    assert disp.shape == (H, W) and np.isfinite(disp).all()
    assert 0 <= disp.min() and disp.max() <= MAX_DISP
    png = np.asarray(Image.open(out))
    assert png.shape == (H, W) and png.dtype == np.uint16
