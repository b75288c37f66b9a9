"""CasGwcNet training in the port vs the JAX package's, on the CPU.

One train step of a tiny CasGwcNet (32×64, max_disp 32, ndisps (16, 8),
intervals (2, 1), the neighbourhood search on; the features at the
config's widths) in f64 on both sides, with the CasGwcNet config's RMSprop
and GRAD_METHOD detach, against JAX's `value_and_grad` of the flax
CasGwcNet (`tests/torch_train_step.py` has the protocol and the
tolerances): both stages' four heads, weighted 0.5, 0.5, 0.7, 1.0 within a
stage and 0.5, 1.0 across, and the features run once per view. The same
compile also holds GRAD_METHOD undetach, whose gradient flows from the
second stage back through its sample grid (the neighbourhood search, the
resizes) and the warps' positions into the first stage. Also: FREEZE_BN,
the evaluation with kernels on and off after the step, the training CLI on
the CasGwcNet config and the overfit recipe.
"""

import pytest

from openstereo_tpu.models.casnet import CasGwcNet as FlaxCasGwcNet
from openstereo_tpu.utils.torch_convert import convert_casnet

from openstereo_tpu_torch.models.casnet import CasGwcNet
from openstereo_tpu_torch.utils import jax_weights as jw

import torch_train_step as ts
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

TINY = dict(max_disp=32, ndisps=(16, 8), disp_interval_pixel=(2.0, 1.0))
CASE = ts.Case(FlaxCasGwcNet, CasGwcNet, TINY, (32, 64), "cfgs/casnet/casnet_gwc_sceneflow.yaml",
               jw.casnet_state_dict_from_jax, convert_casnet)
BACKBONE_BN = "feature_extraction.firstconv_a.0.1"
HEAD_BN = "cost_agg.1.classif0.0.1"


@pytest.fixture(scope="module")
def both():
    return ts.steps(CASE, {"undetach": dict(grad_method="undetach")})


@pytest.fixture(scope="module")
def jax_step(both):
    return both[0]


@pytest.fixture(scope="module")
def port_step(both):
    return both[1]


def test_train_step_loss(jax_step, port_step):
    ts.check_loss(jax_step, port_step, "CasGwcNet")


def test_train_step_gradients(jax_step, port_step):
    ts.check_gradients(jax_step, port_step)


def test_undetach_loss_and_gradients(jax_step, port_step):
    """GRAD_METHOD undetach against JAX's, and unlike detach: the first
    stage's weights get the second stage's gradient through the samples."""
    ref, got = ts.variant(jax_step, port_step, "undetach")
    assert got["model"].grad_method == "undetach"
    ts.check_loss(ref, got, "CasGwcNet undetach")
    ts.check_gradients(ref, got)
    k = "cost_agg.0.classif3.2.weight"  # the first stage's last head
    assert float((ref["grads"][k] - jax_step["grads"][k]).abs().max()) > 1e-6 * float(
        jax_step["grads"][k].abs().max())


def test_train_step_updated_parameters(jax_step, port_step):
    assert port_step["opt"] == "rmsprop"
    ts.check_updated_parameters(jax_step, port_step)


def test_train_step_batchnorm_statistics(jax_step, port_step):
    ts.check_batchnorm_statistics(jax_step, port_step, BACKBONE_BN, HEAD_BN)


def test_freeze_bn_keeps_running_statistics(jax_step):
    ts.check_freeze_bn(CASE, jax_step, BACKBONE_BN)


def test_eval_with_kernels_after_the_step(jax_step, port_step):
    ts.check_eval_after_step(CASE, jax_step, port_step)


def test_train_cli_runs_the_casgwcnet_config_on_cpu(tmp_path, monkeypatch):
    ts.check_train_cli(CASE, tmp_path, monkeypatch)


def test_overfit_recipe_runs_two_steps():
    ts.check_overfit_recipe(CASE, "CasGwcNet", {"NDISPS": [16, 8],
                                                "DISP_INTERVAL_PIXEL": [2.0, 1.0]})
