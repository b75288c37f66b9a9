"""CasPSMNet training in the port vs the JAX package's, on the CPU.

One train step of a tiny CasPSMNet (32×64, max_disp 32, ndisps (16, 8),
intervals (2, 1), the neighbourhood search on; the SPP-FPN features at the
config's widths) in f64 on both sides, with the CasPSMNet config's RMSprop
and GRAD_METHOD detach, against JAX's `value_and_grad` of the flax
CasPSMNet compiled once for the file (`tests/torch_train_step.py` has the
protocol and the tolerances; `tests/test_torch_train_casgwcnet.py` has the
cascade's undetach). Also: FREEZE_BN, the evaluation with kernels on and
off after the step, the training CLI on both CasPSMNet configs and the
overfit recipe.
"""

import pytest

from openstereo_tpu.models.casnet import CasPSMNet as FlaxCasPSMNet
from openstereo_tpu.utils.torch_convert import convert_casnet

from openstereo_tpu_torch.models.casnet import CasPSMNet
from openstereo_tpu_torch.utils import jax_weights as jw

import torch_train_step as ts
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

TINY = dict(max_disp=32, ndisps=(16, 8), disp_interval_pixel=(2.0, 1.0))
CASE = ts.Case(FlaxCasPSMNet, CasPSMNet, TINY, (32, 64), "cfgs/casnet/casnet_psm_sceneflow.yaml",
               jw.casnet_state_dict_from_jax, convert_casnet, seed=33)
BACKBONE_BN = "feature_extraction.firstconv_a.0.1"
HEAD_BN = "cost_agg.1.classif0.0.1"
CONFIGS = ["cfgs/casnet/casnet_psm_sceneflow.yaml", "cfgs/casnet/casnet_psm_sceneflow_uniform.yaml"]


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
    ts.check_loss(jax_step, port_step, "CasPSMNet")


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


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c.split("/")[-1][:-5])
def test_train_cli_runs_the_caspsmnet_configs_on_cpu(tmp_path, monkeypatch, cfg):
    ts.check_train_cli(CASE, tmp_path, monkeypatch, cfg=cfg)


def test_overfit_recipe_runs_two_steps():
    ts.check_overfit_recipe(CASE, "CasPSMNet", {"NDISPS": [16, 8],
                                                "DISP_INTERVAL_PIXEL": [2.0, 1.0]})
