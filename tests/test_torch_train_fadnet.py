"""FADNet training in the port vs the JAX package's, on the CPU.

One train step of a tiny FADNet (64×128, max_disp 64, so the correlation
volume has D 24; encoder ratio 2 and decoder ratio 4, as
`tests/test_torch_fadnet.py`) in f64 on both sides, with the FADNet
config's Lamb, against JAX's `value_and_grad` of the flax FADNet and the
JAX trainer's `optax.lamb` chain, compiled once for the file
(`tests/torch_train_step.py` has the protocol and the tolerances). The
step's gradient reaches the first network's flow through the warp's
coordinates, as in JAX, and the stage-1 encoder runs once per view. The
loss (`losses.flow_pyramid_loss`) is also held alone against the flax
model's `get_loss` on pyramids whose pooled targets cross max_disp, in f64
and f32. Also: FREEZE_BN, the evaluation with kernels on and off after the
step, the training CLI on both FADNet configs and the overfit recipe. H
and W are multiples of 64, as the loss's 1/64 scale needs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openstereo_tpu.models.fadnet import FADNet as FlaxFADNet
from openstereo_tpu.utils.torch_convert import convert_fadnet

from openstereo_tpu_torch.models.fadnet import FADNet
from openstereo_tpu_torch.models.losses import FLOW_PYRAMID_WEIGHTS, flow_pyramid_loss
from openstereo_tpu_torch.utils import jax_weights as jw

import torch_train_step as ts
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

TINY = dict(max_disp=64, encoder_ratio=2, decoder_ratio=4)
CASE = ts.Case(FlaxFADNet, FADNet, TINY, (64, 128), "cfgs/fadnet/fadnet_sceneflow.yaml",
               jw.fadnet_state_dict_from_jax, convert_fadnet, crop=(64, 128), pad=(128, 192))
BACKBONE_BN = "backbone.conv2.bn1"
HEAD_BN = "disp_predictor.conv2.bn1"
CONFIGS = ["cfgs/fadnet/fadnet_sceneflow.yaml", "cfgs/fadnet/fadnet_sceneflow_uniform.yaml"]


@pytest.fixture(scope="module")
def both():
    return ts.steps(CASE)


@pytest.fixture(scope="module")
def jax_step(both):
    return both[0]


@pytest.fixture(scope="module")
def port_step(both):
    return both[1]


def test_train_step_loss(jax_step, port_step):
    ts.check_loss(jax_step, port_step, "FADNet")


def test_train_step_gradients(jax_step, port_step):
    ts.check_gradients(jax_step, port_step)


def test_train_step_updated_parameters(jax_step, port_step):
    assert port_step["opt"] == "lamb"
    ts.check_updated_parameters(jax_step, port_step)


def test_train_step_batchnorm_statistics(jax_step, port_step):
    ts.check_batchnorm_statistics(jax_step, port_step, BACKBONE_BN, HEAD_BN)


def test_freeze_bn_keeps_running_statistics(jax_step):
    ts.check_freeze_bn(CASE, jax_step, BACKBONE_BN)


def test_eval_with_kernels_after_the_step(jax_step, port_step):
    ts.check_eval_after_step(CASE, jax_step, port_step)


def pyramid_inputs(seed, b=2, h=64, w=128, max_disp=64.0):
    """Flows [B,h/2^i,w/2^i,1] for i = 0..6 (two pyramids) and a ground truth
    [B,H,W] whose 2×2 means cross max_disp: values just below and above it
    side by side, zeros (invalid) beside valid values, and negatives."""
    rng = np.random.RandomState(seed)
    gt = rng.rand(b, h, w) * 1.2 * max_disp
    gt[:, ::2, ::2] = max_disp - 0.5 * rng.rand(b, h // 2, w // 2)  # valid, beside ...
    gt[:, 1::2, 1::2] = max_disp + 3.0 * rng.rand(b, h // 2, w // 2)  # ... invalid
    gt[:, :8] = 0.0
    gt[:, -4:, :16] = -1.0
    pyramids = [[rng.randn(b, h >> i, w >> i, 1) * max_disp for i in range(7)] for _ in range(2)]
    return gt, pyramids


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_flow_pyramid_loss_matches_jax(dtype):
    gt, pyramids = pyramid_inputs(5)
    gt, pyramids = gt.astype(dtype), [[f.astype(dtype) for f in p] for p in pyramids]
    pooled = gt
    crossings = 0
    for _ in range(6):  # pooled targets on the other side of max_disp than an input of theirs
        nxt = pooled.reshape(2, pooled.shape[1] // 2, 2, pooled.shape[2] // 2, 2).mean((2, 4))
        crossings += int(((nxt < 64) != (pooled[:, ::2, ::2] < 64)).sum())
        pooled = nxt
    assert crossings > 100
    with jax.enable_x64(dtype == np.float64):
        ref = FlaxFADNet(**TINY).get_loss(
            {"flows_c": [jnp.asarray(f) for f in pyramids[0]],
             "flows_res": [jnp.asarray(f) for f in pyramids[1]]}, {"disp": jnp.asarray(gt)})[0]
        ref = float(ref)
    got = flow_pyramid_loss([[torch.from_numpy(f).permute(0, 3, 1, 2) for f in p]
                             for p in pyramids], torch.from_numpy(gt), 64)
    print(f"flow pyramid loss {dtype.__name__}: port {float(got)!r}, JAX {ref!r}")
    assert got.dtype == torch.from_numpy(gt).dtype
    np.testing.assert_allclose(float(got), ref, rtol=1e-12 if dtype == np.float64 else 1e-6)
    assert len(FLOW_PYRAMID_WEIGHTS) == 7


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c.split("/")[-1][:-5])
def test_train_cli_runs_the_fadnet_configs_on_cpu(tmp_path, monkeypatch, cfg):
    ts.check_train_cli(CASE, tmp_path, monkeypatch, cfg=cfg)


def test_overfit_recipe_runs_two_steps():
    ts.check_overfit_recipe(CASE, "FADNet", {"ENCODER_RATIO": 2, "DECODER_RATIO": 4})
