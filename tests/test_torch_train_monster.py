"""MonSter training in the port vs the JAX package's, on the CPU.

One train step of a tiny MonSter (32×64, encoder vits, max_disp 32, 3 train
iterations of which 2 mutual, so that both loops and REMP run; every other
width as the config's: hidden 128, 3 GRU layers, 8 groups, 2 correlation
levels, radius 4) in f64 on both sides, with the SceneFlow config's AdamW,
OneCycleLR and clip by norm, against JAX's `value_and_grad` of the flax
MonSter compiled once for the file (`tests/torch_train_step.py` has the
protocol and the tolerances). The step holds the frozen ViT and depth
head (no gradient in the port, `stop_gradient` in JAX's; AdamW's decay
alone moves them in both), the trainable pyramid decoder, the plain
group-wise volume, the stem, feature gate and hourglass with training
BatchNorms, the IGEV iterations and the mutual ones under autograd with
both disparities detached, the scale-and-shift alignment on the detached
disparity, the iterates upsampled in three folded calls (`spx_2_gru`'s
BatchNorm updated three times), REMP's training BatchNorms, the training
heads and the sequence loss over 1 + 2·2 iterates. Also: `get_loss` alone
against flax's, the loops without their detach leave JAX's gradients,
FREEZE_BN (on in the config; the step runs it off), the evaluation with
kernels on and off after the step, the training CLI on the SceneFlow
config with its training transforms, the overfit recipe, and the config's
TRAIN_ITERS, VALID_ITERS and the default MIX_ITERS reaching the model.
"""

import pytest

from openstereo_tpu.models.monster import MonSter as FlaxMonSter
from openstereo_tpu.utils.torch_convert import convert_monster

from openstereo_tpu_torch.config import load_config
from openstereo_tpu_torch.models import build_model
from openstereo_tpu_torch.models.monster import MonSter
from openstereo_tpu_torch.utils import jax_weights as jw

import torch_train_step as ts
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

CFG = "cfgs/monster/monster_sceneflow.yaml"
CASE = ts.Case(FlaxMonSter, MonSter,
               dict(max_disp=32, encoder="vits", train_iters=3, valid_iters=3, mix_iters=2),
               (32, 64), CFG, jw.monster_state_dict_from_jax, convert_monster, crop=(32, 64),
               pad=(64, 96))
FROZEN = ("mono_encoder.", "mono_decoder.")
DETACH_IN = ("monster.monster",)


@pytest.fixture(scope="module", autouse=True)
def alignment_in_f64():
    """Both models solve the scale-and-shift alignment in f32 by design (each
    casts its inputs to f32); its 2×2 solve cancels, so the two packages'
    f32 sums leave the f64 step's loss ~1e-7 apart. For this module both
    solve it in f64 from the same f32-rounded inputs (`compute_scale_shift`
    alone is held against JAX's and an f64 solution in
    `tests/test_torch_monster.py`)."""
    import jax.numpy as jnp

    from openstereo_tpu.models.monster import monster as jm
    from openstereo_tpu_torch.models.monster import monster as tm

    jfn, tfn = jm.compute_scale_shift, tm.compute_scale_shift
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jm, "compute_scale_shift",
                   lambda m, d: jfn(m.astype(jnp.float64), d.astype(jnp.float64)))
        mp.setattr(tm, "compute_scale_shift", lambda m, d: tfn(m.double(), d.double()))
        yield


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
    ts.check_loss(jax_step, port_step, "MonSter")


def test_train_step_gradients(jax_step, port_step):
    ts.check_gradients(jax_step, port_step, frozen=FROZEN)


def test_frozen_mono_branch_gets_no_gradient_and_only_the_decay(jax_step, port_step):
    n = sum(1 for k, _ in port_step["model"].named_parameters() if k.startswith(FROZEN))
    ts.check_frozen_branch(jax_step, port_step, FROZEN, n)
    assert n > 100


def test_sequence_loss_matches_flax():
    ts.check_sequence_loss(CASE)


def test_loops_without_their_detach_leave_the_jax_gradients(jax_step, port_step):
    ts.check_detach_matters(CASE, jax_step, port_step, DETACH_IN)


def test_train_step_updated_parameters(jax_step, port_step):
    assert port_step["opt"] == "adamw"
    ts.check_updated_parameters(jax_step, port_step)


def test_train_step_batchnorm_statistics(jax_step, port_step):
    """`spx_2_gru` updates three times (phase A's iterates, the mutual stereo
    ones, the mono ones, in that order), everything else (the 3D stem, the
    hourglass, REMP) once."""
    ts.check_batchnorm_statistics(jax_step, port_step, None, "REMP.conv_start.bn")
    ts.check_batchnorm_update_counts(port_step, twice=(), thrice=("spx_2_gru.",))


def test_freeze_bn_keeps_running_statistics(jax_step):
    ts.check_freeze_bn(CASE, jax_step, "spx_2_gru.conv1.bn")


def test_eval_with_kernels_after_the_step(jax_step, port_step):
    ts.check_eval_after_step(CASE, jax_step, port_step)


def test_training_outputs_order_and_count(jax_step):
    """train_iters − mix_iters IGEV iterates, then a mono and a stereo iterate
    per mutual iteration: 1 + 2·2 at the tiny size; the mono depth at the
    images' size."""
    model = ts.port_model(CASE, jax_step["variables"])
    out = ts.check_training_outputs(model, ts.torch_batch(jax_step["data"]), n_preds=5)
    assert out["depth_mono"].shape == out["disp_pred"].shape


def test_train_cli_runs_the_sceneflow_config_on_cpu(tmp_path, monkeypatch):
    ts.check_train_cli(CASE, tmp_path, monkeypatch)


def test_overfit_recipe_runs_two_steps():
    ts.check_overfit_recipe(CASE, "MonSter", {"TRAIN_ITERS": 3, "VALID_ITERS": 3, "MIX_ITERS": 2})


def test_config_keys_reach_the_model():
    """TRAIN_ITERS (22), VALID_ITERS (32) and MIX_ITERS (7, the default) as
    the SceneFlow config leaves them, and as changed."""
    c = load_config(str(ts.ROOT / CFG))
    model = build_model(c.MODEL, device="cpu")
    assert (model.encoder, model.train_iters, model.valid_iters, model.mix_iters) == (
        "vits", 22, 32, 7)
    c.MODEL.update(TRAIN_ITERS=5, VALID_ITERS=3, MIX_ITERS=2)
    model = build_model(c.MODEL, device="cpu")
    assert (model.train_iters, model.valid_iters, model.mix_iters) == (5, 3, 2)
