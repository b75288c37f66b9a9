"""IGEV++ training in the port vs the JAX package's, on the CPU.

One train step of a tiny IGEV++ (32×128, max_disp 128, ranges 16/16/32 at
intervals 1/2/4 as its inference test's, DISP_CAPS 48/96/120 so that each
cap masks the ground truth up to 129 px, 3 train iterations; every width
as the config's: hidden dims 128, 3 GRU layers, 2 correlation levels,
radius 4) in f64 on both sides, with the IGEV++ config's AdamW,
OneCycleLR and clip by norm, against JAX's `value_and_grad` of the flax
IGEVPP compiled once for the file (`tests/torch_train_step.py` has the
protocol and the tolerances). 32×128 keeps the 32 planes of the volume at
1/4 within the frame, at half the inference test's rows. The step holds
the per-view trunk, the three InstanceNorm hourglasses, the GRU loop under
autograd with the carried disparity detached, every iterate folded into
the batch of `spx_2_gru` (InstanceNorm), the three range heads through
the one shared set of training heads and the capped, weighted loss.
Also: `get_loss` alone against flax's with the config's caps; the loop
without its detach leaves JAX's gradients; FREEZE_BN; the evaluation
with kernels on and off after the step; the
training CLI on both IGEV++ configs and the overfit recipe; the configs'
TRAIN_ITERS and DISP_CAPS reaching the model.
"""

from pathlib import Path

import pytest

from openstereo_tpu.models.igevpp import IGEVPP as FlaxIGEVPP
from openstereo_tpu.utils.torch_convert import convert_igevpp

from openstereo_tpu_torch.config import load_config
from openstereo_tpu_torch.models import build_model
from openstereo_tpu_torch.models.igevpp import IGEVPP
from openstereo_tpu_torch.utils import jax_weights as jw

import torch_train_step as ts
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

RANGES = dict(s_disp_range=16, s_disp_interval=1, m_disp_range=16, m_disp_interval=2,
              l_disp_range=32, l_disp_interval=4)
CASE = ts.Case(FlaxIGEVPP, IGEVPP, dict(max_disp=128, **RANGES, train_iters=3, valid_iters=2,
                                        disp_caps=(48.0, 96.0, 120.0)),
               (32, 128), "cfgs/igevpp/igevpp_sceneflow_amp.yaml", jw.igevpp_state_dict_from_jax,
               convert_igevpp, crop=(32, 128), pad=(64, 160))
BACKBONE_BN = "feature.bn1"
CFGS = sorted(str(p.relative_to(ts.ROOT)) for p in (ts.ROOT / "cfgs/igevpp").glob("*.yaml"))


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
    ts.check_loss(jax_step, port_step, "IGEV++")


def test_train_step_gradients(jax_step, port_step):
    ts.check_gradients(jax_step, port_step)


def test_sequence_loss_matches_flax_with_the_config_caps():
    ts.check_sequence_loss(CASE, n_init=3, max_disp=768, disp_caps=(192.0, 384.0, 700.0))


def test_loop_without_its_detach_leaves_the_jax_gradients(jax_step, port_step):
    ts.check_detach_matters(CASE, jax_step, port_step)


def test_train_step_updated_parameters(jax_step, port_step):
    assert port_step["opt"] == "adamw"
    ts.check_updated_parameters(jax_step, port_step)


def test_train_step_batchnorm_statistics(jax_step, port_step):
    ts.check_batchnorm_statistics(jax_step, port_step, BACKBONE_BN, "cnet.norm1")
    ts.check_batchnorm_update_counts(port_step)


def test_freeze_bn_keeps_running_statistics(jax_step):
    ts.check_freeze_bn(CASE, jax_step, BACKBONE_BN)


def test_eval_with_kernels_after_the_step(jax_step, port_step):
    ts.check_eval_after_step(CASE, jax_step, port_step)


@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: Path(c).stem)
def test_train_cli_runs_the_igevpp_configs_on_cpu(tmp_path, monkeypatch, cfg):
    ts.check_train_cli(CASE, tmp_path, monkeypatch, cfg=cfg)


def test_overfit_recipe_runs_two_steps():
    ts.check_overfit_recipe(CASE, "IGEVPP", {**{k.upper(): v for k, v in RANGES.items()},
                                             "TRAIN_ITERS": 2, "VALID_ITERS": 2})


@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: Path(c).stem)
def test_config_keys_reach_the_model(cfg):
    """TRAIN_ITERS, VALID_ITERS and DISP_CAPS as the config sets them (the
    caps and TRAIN_ITERS were dropped before; the uniform config sets no
    caps: the defaults, the same three)."""
    c = load_config(str(ts.ROOT / cfg))
    model = build_model(c.MODEL, device="cpu")
    assert (model.train_iters, model.valid_iters) == (22, 32)
    assert model.disp_caps == (192.0, 384.0, 700.0)
    c.MODEL.update(TRAIN_ITERS=5, DISP_CAPS=[100, 200, 300])
    model = build_model(c.MODEL, device="cpu")
    assert (model.train_iters, model.disp_caps) == (5, (100.0, 200.0, 300.0))
