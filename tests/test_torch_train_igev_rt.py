"""IGEV-RT training in the port vs the JAX package's, on the CPU.

One train step of a tiny IGEV-RT (32×64, max_disp 32, 3 train iterations;
every width as the config's: hidden dim 96, 2 correlation levels, radius
4) in f64 on both sides, with the IGEV-RT config's AdamW, OneCycleLR and
clip by norm, against JAX's `value_and_grad` of the flax IGEVRT compiled
once for the file (`tests/torch_train_step.py` has the protocol and the
tolerances; the size is the IGEV file's). The step holds the per-view
trunk, the conv-only hidden state and context (`hnet`, `cnet`: BatchNorms
updated once), the one-GRU loop under autograd with the carried disparity
detached, every iterate folded into `spx_2_gru`'s batch, the training
heads and the sequence loss. Also: `get_loss` alone against flax's with
MAX_DISP 256, where the reference's gate at 192 px acts; the loop without
its detach leaves JAX's gradients; FREEZE_BN; the
evaluation with kernels on and off after the step; the training CLI on
both IGEV-RT configs and the overfit recipe; the configs' TRAIN_ITERS and
VALID_ITERS reaching the model.
"""

from pathlib import Path

import pytest

from openstereo_tpu.models.igev_rt import IGEVRT as FlaxIGEVRT
from openstereo_tpu.utils.torch_convert import convert_igev_rt

from openstereo_tpu_torch.config import load_config
from openstereo_tpu_torch.models import build_model
from openstereo_tpu_torch.models.igev_rt import IGEVRT
from openstereo_tpu_torch.utils import jax_weights as jw

import torch_train_step as ts
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

CASE = ts.Case(FlaxIGEVRT, IGEVRT, dict(max_disp=32, train_iters=3, valid_iters=2), (32, 64),
               "cfgs/igev_rt/igev_rt_sceneflow_amp.yaml", jw.igev_rt_state_dict_from_jax,
               convert_igev_rt, crop=(32, 64), pad=(64, 96))
BACKBONE_BN = "feature.bn1"
CFGS = sorted(str(p.relative_to(ts.ROOT)) for p in (ts.ROOT / "cfgs/igev_rt").glob("*.yaml"))


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
    ts.check_loss(jax_step, port_step, "IGEV-RT")


def test_train_step_gradients(jax_step, port_step):
    ts.check_gradients(jax_step, port_step)


def test_sequence_loss_matches_flax_with_the_192_gate():
    ts.check_sequence_loss(CASE, max_disp=256)


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


def test_eval_with_kernels_after_the_step(jax_step, port_step):
    ts.check_eval_after_step(CASE, jax_step, port_step)


@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: Path(c).stem)
def test_train_cli_runs_the_igev_rt_configs_on_cpu(tmp_path, monkeypatch, cfg):
    ts.check_train_cli(CASE, tmp_path, monkeypatch, cfg=cfg)


def test_overfit_recipe_runs_two_steps():
    ts.check_overfit_recipe(CASE, "IGEVRT", {"TRAIN_ITERS": 2, "VALID_ITERS": 2})


@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: Path(c).stem)
def test_config_keys_reach_the_model(cfg):
    """TRAIN_ITERS and VALID_ITERS as the config sets them (TRAIN_ITERS was
    dropped before)."""
    c = load_config(str(ts.ROOT / cfg))
    model = build_model(c.MODEL, device="cpu")
    assert (model.train_iters, model.valid_iters) == (22, 8)
    c.MODEL.update(TRAIN_ITERS=5)
    assert build_model(c.MODEL, device="cpu").train_iters == 5
