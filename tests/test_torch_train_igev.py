"""IGEV-Stereo training in the port vs the JAX package's, on the CPU.

One train step of a tiny IGEV (32×64, max_disp 32, 3 train iterations;
every width as the config's: hidden dims 128, 3 GRU layers with slow-fast
updates, 2 correlation levels, radius 4) in f64 on both sides, with the
IGEV config's AdamW, MultiStepLR and clip by norm, against JAX's
`value_and_grad` of the flax IGEV compiled once for the file
(`tests/torch_train_step.py` has the protocol and the tolerances). The
step holds the per-view trunk (each backbone BatchNorm updated twice), the
GRU loop under autograd with the carried disparity detached, every iterate
upsampled with the iterations folded into the batch (`spx_2_gru`'s
BatchNorm updated once, over all of them), the training heads and the
sequence loss. The size is half the inference test's 64×128 a side: the
f64 step of JAX's compiled code runs ~35 s there on 4 cores, ~7 s here.
Also: `get_loss` alone against flax's, the loop without its detach
leaves JAX's gradients (the control), FREEZE_BN, MODEL.REMAT bit-equal
(against the step's own gradients), the evaluation with
kernels on and off after the step, the training CLI on both IGEV configs
(SceneFlow and KITTI) and the overfit recipe, and the configs' TRAIN_ITERS,
REMAT and SCAN_UNROLL reaching the model.
"""

from pathlib import Path

import pytest

from openstereo_tpu.models.igev import IGEV as FlaxIGEV
from openstereo_tpu.utils.torch_convert import convert_igev

from openstereo_tpu_torch.config import load_config
from openstereo_tpu_torch.models import build_model
from openstereo_tpu_torch.models.igev import IGEV
from openstereo_tpu_torch.utils import jax_weights as jw

import torch_train_step as ts
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

CASE = ts.Case(FlaxIGEV, IGEV, dict(max_disp=32, train_iters=3, valid_iters=2), (32, 64),
               "cfgs/igev/igev_sceneflow_amp.yaml", jw.igev_state_dict_from_jax, convert_igev,
               crop=(32, 64), pad=(64, 96))
BACKBONE_BN = "feature.bn1"
CFGS = sorted(str(p.relative_to(ts.ROOT)) for p in (ts.ROOT / "cfgs/igev").glob("*.yaml"))


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
    ts.check_loss(jax_step, port_step, "IGEV")


def test_train_step_gradients(jax_step, port_step):
    ts.check_gradients(jax_step, port_step)


def test_sequence_loss_matches_flax():
    ts.check_sequence_loss(CASE)


def test_loop_without_its_detach_leaves_the_jax_gradients(jax_step, port_step):
    ts.check_detach_matters(CASE, jax_step, port_step)


def test_train_step_updated_parameters(jax_step, port_step):
    assert port_step["opt"] == "adamw"
    ts.check_updated_parameters(jax_step, port_step)


def test_train_step_batchnorm_statistics(jax_step, port_step):
    ts.check_batchnorm_statistics(jax_step, port_step, BACKBONE_BN, "spx_2_gru.conv1.bn")
    ts.check_batchnorm_update_counts(port_step)


def test_freeze_bn_keeps_running_statistics(jax_step):
    ts.check_freeze_bn(CASE, jax_step, BACKBONE_BN)


def test_remat_leaves_gradients_and_statistics_bit_equal(jax_step, port_step):
    ts.check_remat(CASE, jax_step, port_step)


def test_eval_with_kernels_after_the_step(jax_step, port_step):
    ts.check_eval_after_step(CASE, jax_step, port_step)


@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: Path(c).stem)
def test_train_cli_runs_the_igev_configs_on_cpu(tmp_path, monkeypatch, cfg):
    ts.check_train_cli(CASE, tmp_path, monkeypatch, cfg=cfg)


def test_overfit_recipe_runs_two_steps():
    ts.check_overfit_recipe(CASE, "IGEV", {"TRAIN_ITERS": 2, "VALID_ITERS": 2})


@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: Path(c).stem)
def test_config_keys_reach_the_model(cfg):
    """TRAIN_ITERS, VALID_ITERS, REMAT and SCAN_UNROLL (the JAX loop's unroll,
    ignored here: numerically the identity) as the config sets them, where
    `build_model` dropped them before."""
    c = load_config(str(ts.ROOT / cfg))
    model = build_model(c.MODEL, device="cpu")
    assert (model.train_iters, model.valid_iters, model.remat, model.scan_unroll) == (
        22, 32, bool(c.MODEL.get("REMAT", False)), 1)
    assert model.remat == cfg.endswith("sceneflow_amp.yaml")
    c.MODEL.update(TRAIN_ITERS=5, SCAN_UNROLL=2, REMAT=False)
    model = build_model(c.MODEL, device="cpu")
    assert (model.train_iters, model.scan_unroll, model.remat) == (5, 2, False)
