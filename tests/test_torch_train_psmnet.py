"""PSMNet training in the port vs the JAX package's, on the CPU.

One train step of a tiny PSMNet (32×64, max_disp 16; the SPP backbone at its
full widths) in f64 on both sides, with the PSMNet config's RMSprop and clip
by norm, against JAX's `value_and_grad` of the flax PSMNet compiled once for
the file (`tests/torch_train_step.py` has the protocol and the tolerances).
Also: FREEZE_BN, the evaluation with kernels on and off after the step,
MODEL.REMAT (bit-equal gradients and running statistics, each BatchNorm
updated once), the training CLI on the PSMNet config and the overfit recipe.
"""

import pytest

from openstereo_tpu.models.psmnet import PSMNet as FlaxPSMNet
from openstereo_tpu.utils.torch_convert import convert_psmnet

from openstereo_tpu_torch.models.psmnet import PSMNet
from openstereo_tpu_torch.utils import jax_weights as jw

import torch_train_step as ts
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

CASE = ts.Case(FlaxPSMNet, PSMNet, dict(max_disp=16), (32, 64),
               "cfgs/psmnet/psmnet_sceneflow.yaml",
               jw.psmnet_state_dict_from_jax, convert_psmnet)
BACKBONE_BN = "Backbone.firstconv.0.1"
HEAD_BN = "CostProcessor.aggregator.classif1.0.1"


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
    ts.check_loss(jax_step, port_step, "PSMNet")


def test_train_step_gradients(jax_step, port_step):
    ts.check_gradients(jax_step, port_step)


def test_train_step_updated_parameters(jax_step, port_step):
    assert port_step["opt"] == "rmsprop"
    ts.check_updated_parameters(jax_step, port_step)


def test_train_step_batchnorm_statistics(jax_step, port_step):
    ts.check_batchnorm_statistics(jax_step, port_step, BACKBONE_BN, HEAD_BN)


def test_freeze_bn_keeps_running_statistics(jax_step):
    ts.check_freeze_bn(CASE, jax_step, BACKBONE_BN)


def test_eval_with_kernels_after_the_step(jax_step, port_step):
    ts.check_eval_after_step(CASE, jax_step, port_step)


def test_remat_leaves_gradients_and_statistics_bit_equal(jax_step):
    ts.check_remat(CASE, jax_step)


def test_train_cli_runs_the_psmnet_config_on_cpu(tmp_path, monkeypatch):
    ts.check_train_cli(CASE, tmp_path, monkeypatch)


def test_overfit_recipe_runs_two_steps():
    ts.check_overfit_recipe(CASE, "PSMNet", {})
