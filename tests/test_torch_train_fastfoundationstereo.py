"""FastFoundationStereo training in the port vs the JAX package's, on the CPU.

One train step of a tiny FastFoundationStereo (32×64, max_disp 32, 2 train
iterations; every other width as the config's: the vitl channel budget
(224 at 1/4) without a ViT, hidden 128, one GRU scale with the 1×1 motion
fuse, volume 28, 8 cosine groups, 2 correlation levels, radius 4) in f64
on both sides, with the SceneFlow config's AdamW, OneCycleLR and clip by
norm, against JAX's `value_and_grad` of the flax FastFoundationStereo
compiled once for the file (`tests/torch_train_step.py` has the protocol
and the tolerances). The step holds both views through the features one
after the other, the plain cosine volume, the 3D stem and the headwise
AHCF hourglass with training BatchNorms, the shared context heads, the GRU
loop under autograd with the carried disparity detached, every iterate
upsampled in one folded call and the sequence loss
(`FSFamily`, FoundationStereo's). Also: `get_loss` alone against flax's,
the loop without its detach leaves JAX's gradients, FREEZE_BN, the
evaluation with kernels on and off after the step, the training CLI on the
SceneFlow config, the overfit recipe, and the config's TRAIN_ITERS and
VALID_ITERS reaching the model.
"""

import pytest

from openstereo_tpu.models.fastfoundationstereo import FastFoundationStereo as FlaxFFS
from openstereo_tpu.utils.torch_convert import convert_fastfoundationstereo

from openstereo_tpu_torch.config import load_config
from openstereo_tpu_torch.models import build_model
from openstereo_tpu_torch.models.fastfoundationstereo import FastFoundationStereo
from openstereo_tpu_torch.utils import jax_weights as jw

import torch_train_step as ts
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

CFG = "cfgs/fast_foundationstereo/ffstereo_sceneflow.yaml"
CASE = ts.Case(FlaxFFS, FastFoundationStereo, dict(max_disp=32, train_iters=2, valid_iters=2),
               (32, 64), CFG, jw.fastfoundationstereo_state_dict_from_jax,
               convert_fastfoundationstereo, crop=(32, 64), pad=(64, 96))
DETACH_IN = ("foundationstereo.foundationstereo",)


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
    ts.check_loss(jax_step, port_step, "FastFoundationStereo")


def test_train_step_gradients(jax_step, port_step):
    ts.check_gradients(jax_step, port_step)


def test_sequence_loss_matches_flax():
    ts.check_sequence_loss(CASE)


def test_loop_without_its_detach_leaves_the_jax_gradients(jax_step, port_step):
    ts.check_detach_matters(CASE, jax_step, port_step, DETACH_IN)


def test_train_step_updated_parameters(jax_step, port_step):
    assert port_step["opt"] == "adamw"
    ts.check_updated_parameters(jax_step, port_step)


def test_train_step_batchnorm_statistics(jax_step, port_step):
    """The 3D stem, the hourglass (its patch BatchNorm included) and the
    classifier each update once: no BatchNorm runs per view."""
    ts.check_batchnorm_statistics(jax_step, port_step, None, "cost_agg.conv_patch.1")
    ts.check_batchnorm_update_counts(port_step, twice=())


def test_freeze_bn_keeps_running_statistics(jax_step):
    ts.check_freeze_bn(CASE, jax_step, "corr_stem.1.bn")


def test_eval_with_kernels_after_the_step(jax_step, port_step):
    ts.check_eval_after_step(CASE, jax_step, port_step)


def test_train_cli_runs_the_sceneflow_config_on_cpu(tmp_path, monkeypatch):
    ts.check_train_cli(CASE, tmp_path, monkeypatch)


def test_overfit_recipe_runs_two_steps():
    ts.check_overfit_recipe(CASE, "FastFoundationStereo", {"TRAIN_ITERS": 2, "VALID_ITERS": 2})


def test_config_keys_reach_the_model():
    """TRAIN_ITERS (12) and VALID_ITERS (8) as the SceneFlow config sets them,
    and as changed."""
    c = load_config(str(ts.ROOT / CFG))
    model = build_model(c.MODEL, device="cpu")
    assert (model.train_iters, model.valid_iters, model.n_gru_layers) == (12, 8, 1)
    c.MODEL.update(TRAIN_ITERS=5, VALID_ITERS=3)
    model = build_model(c.MODEL, device="cpu")
    assert (model.train_iters, model.valid_iters) == (5, 3)
