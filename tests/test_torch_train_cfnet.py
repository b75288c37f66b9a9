"""CFNet training in the port vs the JAX package's, on the CPU.

One train step of a tiny CFNet (32×64, max_disp 64; the config's widths,
groups and sample counts) in f64 on both sides, with the CFNet config's
RMSprop, against JAX's `value_and_grad` of the flax CFNet compiled once for
the file (`tests/torch_train_step.py` has the protocol and the tolerances).
The nine heads, the per-view features and the detached prediction before
the spread and the search range (JAX's `stop_gradient`, `cfnet.py:276`
and `:316`) are all in that one step. The four range scalars (γ, β of each
warped stage) reach the loss only through floors and ceils, so both
packages give them an exactly zero gradient; they are held at the
model-level floor like every other tensor and, on their own, at exactly 0.
Also: FREEZE_BN, the evaluation with kernels on and off after the step,
the training CLI on each of the three CFNet configs and the overfit recipe.
"""

import pytest

from openstereo_tpu.models.cfnet import CFNet as FlaxCFNet
from openstereo_tpu.utils.torch_convert import convert_cfnet

from openstereo_tpu_torch.models.cfnet import CFNet
from openstereo_tpu_torch.utils import jax_weights as jw

import torch_train_step as ts
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

CASE = ts.Case(FlaxCFNet, CFNet, dict(max_disp=64), (32, 64), "cfgs/cfnet/cfnet_sceneflow.yaml",
               jw.cfnet_state_dict_from_jax, convert_cfnet, crop=(32, 64), pad=(64, 96))
BACKBONE_BN = "feature_extraction.firstconv.0.1"
HEAD_BN = "classif0.0.1"
RANGE_SCALARS = ("gamma_s3", "beta_s3", "gamma_s2", "beta_s2")
# each config and the evaluation's size at the tiny crop: part 2 crops (RightBottomCrop)
# where the others pad, so its size lies within the 40×72 pairs
CONFIGS = {"cfgs/cfnet/cfnet_sceneflow.yaml": (64, 96),
           "cfgs/cfnet/cfnet_sceneflow_part1_uniform.yaml": (64, 96),
           "cfgs/cfnet/cfnet_sceneflow_part2.yaml": (32, 64)}


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
    ts.check_loss(jax_step, port_step, "CFNet")


def test_train_step_gradients(jax_step, port_step):
    ts.check_gradients(jax_step, port_step)


def test_range_scalars_get_exactly_zero_gradients(jax_step, port_step):
    for k in RANGE_SCALARS:
        assert float(jax_step["grads"][k]) == 0.0, k
        assert float(port_step["grads"][k]) == 0.0, k


def test_search_range_takes_the_prediction_detached(jax_step, monkeypatch):
    """The spread and the range of each warped stage get the prediction
    without its graph, as JAX's `stop_gradient` gives it; the heads get it
    with its graph."""
    model = ts.port_model(CASE, jax_step["variables"])
    seen = []
    original = model._range_and_samples

    def recording(pred, var, *args):
        seen.append((pred.requires_grad, var.requires_grad))
        return original(pred, var, *args)

    monkeypatch.setattr(model, "_range_and_samples", recording)
    out = model(ts.torch_batch(jax_step["data"]))
    assert seen == [(False, True), (False, True)]
    assert all(p.requires_grad for p in out["disp_preds"]) and len(out["disp_preds"]) == 9


def test_train_step_updated_parameters(jax_step, port_step):
    assert port_step["opt"] == "rmsprop"
    ts.check_updated_parameters(jax_step, port_step)


def test_train_step_batchnorm_statistics(jax_step, port_step):
    ts.check_batchnorm_statistics(jax_step, port_step, BACKBONE_BN, HEAD_BN)


def test_freeze_bn_keeps_running_statistics(jax_step):
    ts.check_freeze_bn(CASE, jax_step, BACKBONE_BN)


def test_eval_with_kernels_after_the_step(jax_step, port_step):
    ts.check_eval_after_step(CASE, jax_step, port_step)


@pytest.mark.parametrize("cfg", list(CONFIGS), ids=lambda c: c.split("/")[-1][:-5])
def test_train_cli_runs_the_cfnet_configs_on_cpu(tmp_path, monkeypatch, cfg):
    ts.check_train_cli(CASE, tmp_path, monkeypatch, cfg=cfg, pad=CONFIGS[cfg])


def test_overfit_recipe_runs_two_steps():
    ts.check_overfit_recipe(CASE, "CFNet", {})

