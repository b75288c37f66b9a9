"""GwcNet training in the port vs the JAX package's, on the CPU.

One train step of a tiny GwcNet (32×64, max_disp 16, 8 groups, 4 concat
channels; the backbone at its full widths) in f64 on both sides, with the
GwcNet config's RMSprop and clip by norm, against JAX's `value_and_grad` of
the flax GwcNet compiled once for the file (`tests/torch_train_step.py`
has the protocol and the tolerances). Also: FREEZE_BN, the evaluation with
kernels on and off after the step, MODEL.REMAT (bit-equal gradients and
running statistics, each BatchNorm updated once), the training CLI on the
GwcNet config with a resumed Trainer, and the overfit recipe.
"""

import pytest

from openstereo_tpu.models.gwcnet import GwcNet as FlaxGwcNet
from openstereo_tpu.utils.torch_convert import convert_gwcnet

from openstereo_tpu_torch.config import load_config
from openstereo_tpu_torch.models import build_model
from openstereo_tpu_torch.models.gwcnet import GwcNet
from openstereo_tpu_torch.utils import jax_weights as jw

import torch_train_step as ts
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

CASE = ts.Case(FlaxGwcNet, GwcNet, dict(max_disp=16, num_groups=8, use_concat_volume=True,
                                        concat_channels=4),
               (32, 64), "cfgs/gwcnet/gwcnet_sceneflow.yaml", jw.gwcnet_state_dict_from_jax,
               convert_gwcnet)
BACKBONE_BN = "Backbone.feature_extraction.firstconv.0.1"
HEAD_BN = "DispProcessor.classif0.0.1"


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
    ts.check_loss(jax_step, port_step, "GwcNet")


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


def test_build_model_reads_model_remat():
    cfg = load_config(str(ts.ROOT / CASE.cfg))
    assert not build_model(cfg.MODEL, device="cpu").remat
    cfg.MODEL["REMAT"] = True
    assert build_model(cfg.MODEL, device="cpu").remat


def test_train_cli_runs_the_gwcnet_config_on_cpu(tmp_path, monkeypatch):
    ts.check_train_cli(CASE, tmp_path, monkeypatch, resume=True)


def test_overfit_recipe_runs_two_steps():
    ts.check_overfit_recipe(CASE, "GwcNet", {"NUM_GROUPS": 8, "CONCAT_CHANNELS": 4})
