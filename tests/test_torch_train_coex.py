"""CoEx training in the port vs the JAX package's, on the CPU.

One train step of a tiny CoEx (48×80, max_disp 16, where the nearest resizes
fire; the trunk and decoder at their full widths) in f64 on both sides, with
the CoEx config's RMSprop and clip by value, against JAX's `value_and_grad`
of the flax CoEx compiled once for the file (`tests/torch_train_step.py` has
the protocol and the tolerances). Also: FREEZE_BN, the evaluation with
kernels on and off after the step, the training CLI on the CoEx config and
the overfit recipe; the training initialiser's fan-in for the transposed
convs and FeatureAtt's gates.
"""

import pytest

from openstereo_tpu.models.coex import CoExNet as FlaxCoExNet
from openstereo_tpu.utils.torch_convert import convert_coex

from openstereo_tpu_torch.models.coex import CoExNet
from openstereo_tpu_torch.utils import jax_weights as jw

import torch_train_step as ts
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

CASE = ts.Case(FlaxCoExNet, CoExNet, dict(max_disp=16), (48, 80),
               "cfgs/coex/coex_sceneflow_amp.yaml",
               jw.coex_state_dict_from_jax, convert_coex, crop=(48, 80), pad=(64, 96))
BACKBONE_BN = "Backbone.feat.bn1"
HEAD_BN = "CostProcessor.cost_agg.conv_stem.bn"


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
    ts.check_loss(jax_step, port_step, "CoEx")


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


def test_train_cli_runs_the_coex_config_on_cpu(tmp_path, monkeypatch):
    ts.check_train_cli(CASE, tmp_path, monkeypatch)


def test_overfit_recipe_runs_two_steps():
    ts.check_overfit_recipe(CASE, "CoExNet", {})


def test_training_init_draws_the_deconvs_and_gates_with_flax_fan_in():
    """The transposed convs (`spx`, FeatUp's, the 3D UNet's) and FeatureAtt's
    gate convs, each family on its own."""
    import torch.nn as nn

    from openstereo_tpu_torch.models.igev.blocks import FeatureAtt

    deconvs = (nn.ConvTranspose2d, nn.ConvTranspose3d)
    assert ts.check_flax_fan_in(
        CASE, lambda model: [m for m in model.modules() if isinstance(m, deconvs)]) >= 6
    assert ts.check_flax_fan_in(
        CASE, lambda model: [m for f in model.modules() if isinstance(f, FeatureAtt)
                             for m in f.modules() if isinstance(m, nn.Conv2d)]) >= 12
