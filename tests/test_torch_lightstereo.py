"""Port LightStereo vs the flax LightStereo, end to end on the CPU, f32.

A tiny model (64×128 input, max_disp 16, blocks (1,2,4), ratio 4) with
numpy-drawn flax variables; the weights go JAX → port through
`lightstereo_state_dict_from_jax`. One jitted flax forward serves every
test of the module. On the CPU the port's kernel wrappers run their plain
versions, so "kernels on" here checks the wiring (folded BatchNorms,
kernel weight layouts) and "kernels off" the eager path.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from openstereo_tpu.models.lightstereo import LightStereo as FlaxLightStereo
from openstereo_tpu.utils.torch_convert import convert_lightstereo

from openstereo_tpu_torch.config import Config
from openstereo_tpu_torch.models import build_model, set_kernels
from openstereo_tpu_torch.models.lightstereo import LightStereo
from openstereo_tpu_torch.utils.jax_weights import lightstereo_state_dict_from_jax

from test_torch_layers import _random_variables
from test_torch_ops import to_nchw
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
H, W, MAX_DISP = 64, 128, 16
TINY = {"NAME": "LightStereo", "MAX_DISP": MAX_DISP, "EXPANSE_RATIO": 4,
        "AGGREGATION_BLOCKS": [1, 2, 4], "LEFT_ATT": True}


@pytest.fixture(scope="module")
def reference():
    """(flax variables, NHWC inputs, flax disparity) — the module's one JAX compile."""
    rng = np.random.RandomState(0)
    data = {k: rng.randn(1, H, W, 3).astype(np.float32) for k in ("left", "right")}
    model = FlaxLightStereo(max_disp=MAX_DISP, aggregation_blocks=(1, 2, 4), expanse_ratio=4)
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    variables = _random_variables(model, jdata, 7)
    disp = jax.jit(lambda v, b: model.apply(v, b, train=False))(variables, jdata)["disp_pred"]
    return variables, data, np.asarray(disp)


def _port(variables, kernels=True):
    m = LightStereo(max_disp=MAX_DISP, aggregation_blocks=(1, 2, 4), expanse_ratio=4)
    m.load_state_dict(lightstereo_state_dict_from_jax(variables))
    return set_kernels(m.eval(), kernels)


def _run(model, data):
    with torch.inference_mode():
        return model({k: to_nchw(v) for k, v in data.items()})["disp_pred"].numpy()


@pytest.mark.parametrize("kernels", [True, False])
def test_lightstereo_matches_flax(reference, kernels):
    variables, data, ref = reference
    got = _run(_port(variables, kernels), data)
    assert got.shape == ref.shape == (1, H, W)
    print(f"LightStereo port (kernels={kernels}) vs flax: max-abs {np.abs(got - ref).max():.3g} px, "
          f"disparity range {ref.min():.2f}..{ref.max():.2f}")
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)


def test_kernel_path_matches_eager_path(reference):
    variables, data, _ = reference
    wired, eager = _run(_port(variables, True), data), _run(_port(variables, False), data)
    print(f"LightStereo kernel path vs eager path (CPU): max-abs {np.abs(wired - eager).max():.3g} px")
    np.testing.assert_allclose(wired, eager, rtol=0, atol=1e-4)


def test_state_dict_round_trip_is_exact(reference):
    """port state_dict → the JAX package's converter → the flax variables."""
    variables = reference[0]
    back = convert_lightstereo({k: v.numpy() for k, v in _port(variables).state_dict().items()})
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])  # noqa: E731
    a, b = flat(back), flat(variables)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=str(k))


def test_build_model_refuses_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(Config.from_dict(TINY))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(Config.from_dict(TINY), device="cuda")


def test_build_model_seeded_and_unported_names():
    a = build_model(Config.from_dict(TINY), device="cpu", seed=3).state_dict()
    b = build_model(Config.from_dict(TINY), device="cpu", seed=3).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(NotImplementedError, match="Slice F, item 17"):
        build_model(Config.from_dict({"NAME": "AANet"}), device="cpu")


def test_load_pretrained_reads_reference_checkpoints(tmp_path):
    """{'model_state': sd} with DDP's 'module.' prefix, as the reference saves."""
    from openstereo_tpu_torch.tools.infer import load_pretrained

    src = build_model(Config.from_dict(TINY), device="cpu", seed=1)
    torch.save({"model_state": {f"module.{k}": v for k, v in src.state_dict().items()},
                "epoch": 3}, tmp_path / "ckpt.pth")
    dst = build_model(Config.from_dict(TINY), device="cpu", seed=2)
    assert load_pretrained(dst, str(tmp_path / "ckpt.pth")) == len(src.state_dict())
    a, b = src.state_dict(), dst.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_eval_transforms_match_jax():
    from openstereo_tpu.data.transforms import build_transforms as jax_transforms
    from openstereo_tpu_torch.data.transforms import build_transforms

    cfg = yaml.safe_load((ROOT / "cfgs/lightstereo/lightstereo_s_sceneflow.yaml").read_text())
    spec = cfg["DATA_CONFIG"]["DATA_TRANSFORM"]["EVALUATING"]
    rng = np.random.RandomState(5)
    sample = {"left": rng.rand(500, 900, 3).astype(np.float32) * 255,
              "right": rng.rand(500, 900, 3).astype(np.float32) * 255,
              "disp": rng.rand(500, 900).astype(np.float32)}
    got = build_transforms(spec)({k: v.copy() for k, v in sample.items()})
    ref = jax_transforms(spec)({k: v.copy() for k, v in sample.items()})
    for k in sample:
        np.testing.assert_array_equal(got[k], ref[k])
    # the training pipeline builds too, and draws what JAX's draws (more in test_torch_data.py)
    train = cfg["DATA_CONFIG"]["DATA_TRANSFORM"]["TRAINING"]
    got = build_transforms(train)({**{k: v.copy() for k, v in sample.items()},
                                   "_rng": np.random.default_rng(3)})
    ref = jax_transforms(train)({**{k: v.copy() for k, v in sample.items()},
                                 "_rng": np.random.default_rng(3)})
    for k in sample:
        assert got[k].shape[:2] == (320, 736)
        np.testing.assert_array_equal(got[k], ref[k])


def test_infer_cli_on_cpu(tmp_path):
    from PIL import Image

    from openstereo_tpu_torch.tools import infer

    cfg = {"DATA_CONFIG": {"DATA_TRANSFORM": {"EVALUATING": [
        {"NAME": "RightTopPad", "SIZE": [H, W]},
        {"NAME": "NormalizeImage", "MEAN": [0.485, 0.456, 0.406], "STD": [0.229, 0.224, 0.225]},
    ]}}, "MODEL": TINY}
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(cfg))
    img = (np.random.RandomState(6).rand(60, 120, 3) * 255).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "left.png")
    Image.fromarray(np.roll(img, -4, axis=1)).save(tmp_path / "right.png")
    out = tmp_path / "disp.png"
    disp = infer.main(["--cfg_file", str(tmp_path / "tiny.yaml"),
                       "--left_img_path", str(tmp_path / "left.png"),
                       "--right_img_path", str(tmp_path / "right.png"),
                       "--out", str(out), "--device", "cpu"])
    png = np.asarray(Image.open(out))
    assert png.shape == (H, W) and disp.shape == (H, W)
    assert np.isfinite(disp).all() and 0 <= disp.min() and disp.max() <= MAX_DISP
    np.testing.assert_array_equal(png, (disp * 256).astype(np.uint16))
