"""Port GwcNet vs the flax GwcNet of the JAX package, eval, f32, on the CPU.

A tiny model (32×64 input, max_disp 16, 8 groups, 4 concat channels; the
backbone keeps its full widths, so the group-wise features are 320
channels) with numpy-drawn flax variables of the training graph (so that
`classif0`-`classif2` exist, as the converter expects them); the weights go
JAX → port through `gwcnet_state_dict_from_jax`. The flax forward is
jitted once per module and captures every submodule's output, which the
module tests feed to the port's GwcBackbone and GwcHourglass. Modules are
held at rtol 1e-4 (`tests/test_layer_parity.py`) and an atol of 1e-5 times
the largest output: under random weights the residual and skip sums grow
the activations to ~100-1000, and f32 sums taken in another order over tens
of convs differ by ~1e-6 of that scale. The whole model is held at atol
1e-3 px, the tolerance of the earlier slices. The JAX 3D convs run their
tap-merged CPU lowering: the same sums in another order.

On the CPU the K3 wrapper runs its plain version, so "kernels on" checks
the wiring of K3 and "kernels off" the eager path.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from openstereo_tpu.models.gwcnet import GwcNet as FlaxGwcNet
from openstereo_tpu.utils.torch_convert import convert_gwcnet

from openstereo_tpu_torch.config import load_config
from openstereo_tpu_torch.models import build_model, set_kernels
from openstereo_tpu_torch.models.gwcnet import GwcNet
from openstereo_tpu_torch.models.gwcnet.gwcnet import GwcBackbone, GwcHourglass
from openstereo_tpu_torch.utils import jax_weights as jw

from test_torch_layers import _random_variables
from test_torch_ops import to_nchw
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
CFG = ROOT / "cfgs/gwcnet/gwcnet_sceneflow.yaml"
H, W = 32, 64
TINY = dict(max_disp=16, num_groups=8, use_concat_volume=True, concat_channels=4)


def to_ncdhw(a):
    """JAX NDHWC → port NCDHW, as a torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def close_to_scale(got, ref, what):
    """rtol 1e-4, atol 1e-5·max|ref| (see the module docstring)."""
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.abs(ref).max()
    print(f"{what} max-abs {np.abs(got - ref).max():.3g}, max|ref| {scale:.3g}")
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * scale)


@pytest.fixture(scope="module")
def reference():
    """(flax variables, NHWC inputs, flax disparity, captured module outputs):
    the module's one JAX compile."""
    rng = np.random.RandomState(0)
    data = {k: rng.randn(1, H, W, 3).astype(np.float32) for k in ("left", "right")}
    model = FlaxGwcNet(**TINY)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    variables = _random_variables(model, jdata, 11, train=True)
    out, state = jax.jit(lambda v, b: model.apply(v, b, train=False, capture_intermediates=True,
                                                  mutable=["intermediates"]))(variables, jdata)
    return variables, data, np.asarray(out["disp_pred"]), state["intermediates"]


def _port(variables, kernels=True):
    m = GwcNet(**TINY)
    m.load_state_dict(jw.gwcnet_state_dict_from_jax(variables))
    return set_kernels(m.eval(), kernels)


def _run(model, data):
    with torch.inference_mode():
        return model({k: to_nchw(v) for k, v in data.items()})["disp_pred"].numpy()


@pytest.mark.parametrize("kernels", [True, False])
def test_gwcnet_matches_flax(reference, kernels):
    variables, data, ref, _ = reference
    got = _run(_port(variables, kernels), data)
    assert got.shape == ref.shape == (1, H, W)
    print(f"GwcNet port (kernels={kernels}) vs flax: max-abs {np.abs(got - ref).max():.3g} px, "
          f"disparity range {ref.min():.2f}..{ref.max():.2f}")
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


def test_kernel_path_matches_eager_path(reference):
    variables, data, _, _ = reference
    wired, eager = _run(_port(variables, True), data), _run(_port(variables, False), data)
    print(f"GwcNet kernel path vs eager path (CPU): max-abs {np.abs(wired - eager).max():.3g} px")
    np.testing.assert_allclose(wired, eager, rtol=0, atol=1e-4)


def test_gwc_backbone_matches_flax(reference):
    """The siamese 2B batch through the port's GwcBackbone vs the flax
    backbone's captured output."""
    variables, data, _, inter = reference
    b = jw.FlaxToTorch({"params": variables["params"]["backbone"],
                        "batch_stats": variables["batch_stats"]["backbone"]})
    jw.gwc_backbone(b, "", "")
    port = GwcBackbone(concat_feature=True, concat_channels=4)
    port.load_state_dict(b.finish())
    x = np.concatenate([data["left"], data["right"]])
    with torch.inference_mode():
        got = port.eval()(to_nchw(x))
    ref = inter["backbone"]["__call__"][0]
    for key, channels in (("gwc_feature", 320), ("concat_feature", 4)):
        assert got[key].shape == (2, channels, H // 4, W // 4)
        close_to_scale(np.moveaxis(got[key].numpy(), 1, -1), ref[key], f"GwcBackbone {key}")


@pytest.mark.parametrize("name,prev", [("dres3", "dres2"), ("dres4", "dres3")])
def test_gwc_hourglass_matches_flax(reference, name, prev):
    """The port's hourglass `name` on the flax output of the one before it."""
    variables, _, _, inter = reference
    b = jw.FlaxToTorch({"params": variables["params"][name],
                        "batch_stats": variables["batch_stats"][name]})
    jw.gwc_hourglass(b, "", "")
    port = GwcHourglass(32)
    port.load_state_dict(b.finish())
    with torch.inference_mode():
        got = port.eval()(to_ncdhw(inter[prev]["__call__"][0]))
    close_to_scale(np.moveaxis(got.numpy(), 1, -1), inter[name]["__call__"][0],
                   f"GwcHourglass {name}")


def test_gwcnet_state_dict_round_trip_is_exact(reference):
    """port state_dict → the JAX package's converter → the flax variables."""
    variables = reference[0]
    back = convert_gwcnet({k: v.numpy() for k, v in _port(variables).state_dict().items()})
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])  # noqa: E731
    a, b = flat(back), flat(variables)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=str(k))


def test_build_model_reads_the_gwcnet_config():
    cfg = load_config(str(CFG))
    model = build_model(cfg.MODEL, device="cpu", seed=0)
    assert isinstance(model, GwcNet) and not model.training
    assert (model.num_groups, model.max_disp, model.downsample) == (40, 192, 4)
    assert model.DispProcessor.dres0[0][0].weight.shape == (32, 64, 3, 3, 3)
    assert model.Backbone["feature_extraction"].lastconv[2].weight.shape == (12, 128, 1, 1)
    ref = convert_gwcnet({k: v.numpy() for k, v in model.state_dict().items()})
    assert set(ref["params"]) >= {"backbone", "dres0a", "dres4", "classif0a", "classif3b"}


def test_infer_cli_on_cpu_with_the_gwcnet_config(tmp_path):
    """The GwcNet config's transforms and MODEL section, cut to max_disp 16,
    8 groups and a 32×64 pad so that the CPU run stays short."""
    from PIL import Image

    from openstereo_tpu_torch.tools import infer

    cfg = yaml.safe_load(CFG.read_text())
    cfg["MODEL"].update({k.upper(): v for k, v in TINY.items()})
    cfg["DATA_CONFIG"]["DATA_TRANSFORM"]["EVALUATING"][0]["SIZE"] = [H, W]
    (tmp_path / "gwcnet.yaml").write_text(yaml.safe_dump(cfg))
    img = (np.random.RandomState(15).rand(30, 60, 3) * 255).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "left.png")
    Image.fromarray(np.roll(img, -3, axis=1)).save(tmp_path / "right.png")
    out = tmp_path / "disp.png"
    disp = infer.main(["--cfg_file", str(tmp_path / "gwcnet.yaml"),
                       "--left_img_path", str(tmp_path / "left.png"),
                       "--right_img_path", str(tmp_path / "right.png"),
                       "--out", str(out), "--device", "cpu"])
    assert disp.shape == (H, W) and np.isfinite(disp).all()
    assert 0 <= disp.min() and disp.max() <= TINY["max_disp"]
    png = np.asarray(Image.open(out))
    assert png.shape == (H, W) and png.dtype == np.uint16
