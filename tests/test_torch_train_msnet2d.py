"""MSNet2D training in the port vs the JAX package's, on the CPU.

One train step of a tiny MSNet2D (32×64, max_disp 16, hourglass width 4; the
mobile trunk at its full widths) in f64 on both sides, with the MSNet2D
config's Adam (no clip), against JAX's `value_and_grad` of the flax MSNet2D
compiled once for the file (`tests/torch_train_step.py` has the protocol and
the tolerances). Also: FREEZE_BN, the evaluation with kernels on and off
after the step, the training CLI on the MSNet2D config and the overfit
recipe.
"""

import pytest

from openstereo_tpu.models.msnet import MSNet2D as FlaxMSNet2D
from openstereo_tpu.utils.torch_convert import convert_msnet2d

from openstereo_tpu_torch.models.msnet import MSNet2D
from openstereo_tpu_torch.utils import jax_weights as jw

import torch_train_step as ts
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

CASE = ts.Case(FlaxMSNet2D, MSNet2D, dict(max_disp=16, hg_size=4), (32, 64),
               "cfgs/msnet/msnet2d_sceneflow.yaml",
               jw.msnet2d_state_dict_from_jax, convert_msnet2d)
BACKBONE_BN = "feature_extraction.firstconv.0.conv.1"
HEAD_BN = "classif0.0.1"


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
    ts.check_loss(jax_step, port_step, "MSNet2D")


def test_train_step_gradients(jax_step, port_step):
    ts.check_gradients(jax_step, port_step)


def test_train_step_updated_parameters(jax_step, port_step):
    assert port_step["opt"] == "adam"
    ts.check_updated_parameters(jax_step, port_step)


def test_train_step_batchnorm_statistics(jax_step, port_step):
    ts.check_batchnorm_statistics(jax_step, port_step, BACKBONE_BN, HEAD_BN)


def test_freeze_bn_keeps_running_statistics(jax_step):
    ts.check_freeze_bn(CASE, jax_step, BACKBONE_BN)


def test_eval_with_kernels_after_the_step(jax_step, port_step):
    ts.check_eval_after_step(CASE, jax_step, port_step)


def test_train_cli_runs_the_msnet2d_config_on_cpu(tmp_path, monkeypatch):
    ts.check_train_cli(CASE, tmp_path, monkeypatch)


def test_overfit_recipe_runs_two_steps():
    ts.check_overfit_recipe(CASE, "MSNet2D", {"HG_SIZE": 4})
