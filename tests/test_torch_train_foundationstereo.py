"""FoundationStereo training in the port vs the JAX package's, on the CPU.

One train step of a tiny FoundationStereo (32×64, ViT vits, max_disp 32,
2 train iterations; every other width as the config's: hidden 128, 3 GRU
layers, volume 28, 8 cosine groups, 2 correlation levels, radius 4) in
f64 on both sides, with the SceneFlow config's AdamW, OneCycleLR and clip
by norm, against JAX's `value_and_grad` of the flax FoundationStereo
compiled once for the file (`tests/torch_train_step.py` has the protocol
and the tolerances; the ViT branch's VJP is a second, smaller compile). The step holds both views through the features one
after the other, the frozen DepthAnythingV2 branch (no gradient in the
port, `stop_gradient` in JAX's; AdamW's decay alone moves it in both),
the plain cosine volume, the 3D stem, AHCF hourglass and context net with
training BatchNorms, the GRU loop under autograd with the carried
disparity detached, every iterate upsampled in one folded call through the
norm-free `spx_2_gru`, the initial disparity resized ×4 and the sequence
loss. Also: the step with FREEZE_VIT false (the branch's gradients),
`get_loss` alone against flax's, the loop without its detach leaves JAX's
gradients (the control), FREEZE_BN, the evaluation with
kernels on and off after the step, the training CLI on the SceneFlow
config and the overfit recipe, and the config's TRAIN_ITERS, VALID_ITERS
and FREEZE_VIT reaching the model, and the training initialisation's flax
defaults for the ViT's and EdgeNeXt's scales.
"""

import pytest

from openstereo_tpu.models.foundationstereo import FoundationStereo as FlaxFoundationStereo
from openstereo_tpu.utils.torch_convert import convert_foundationstereo

from openstereo_tpu_torch.config import load_config
from openstereo_tpu_torch.models import build_model
from openstereo_tpu_torch.models.foundationstereo import FoundationStereo
from openstereo_tpu_torch.utils import jax_weights as jw

import torch_train_step as ts
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

CFG = "cfgs/foundationstereo/fstereo_sceneflow.yaml"
CASE = ts.Case(FlaxFoundationStereo, FoundationStereo,
               dict(max_disp=32, vit_size="vits", train_iters=2, valid_iters=2), (32, 64), CFG,
               jw.foundationstereo_state_dict_from_jax, convert_foundationstereo,
               crop=(32, 64), pad=(64, 96))
FROZEN = ("feature.dino.",)
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
    ts.check_loss(jax_step, port_step, "FoundationStereo")


def test_train_step_gradients(jax_step, port_step):
    ts.check_gradients(jax_step, port_step, frozen=FROZEN)


def test_frozen_vit_gets_no_gradient_and_only_the_decay(jax_step, port_step):
    n = sum(1 for k, _ in port_step["model"].named_parameters() if k.startswith(FROZEN))
    ts.check_frozen_branch(jax_step, port_step, FROZEN, n)
    assert n > 100


def test_unfrozen_vit_gradients_match_flax(jax_step, port_step):
    """FREEZE_VIT false: the step's gradients also flow into the
    DepthAnythingV2 branch. JAX's `stop_gradient` holds back only the
    branch's own gradients, so every other one is the frozen step's; the
    branch's are the VJP of flax's `DepthAnythingV2` at both views' inputs
    with the port's cotangents of its features (the chain rule of flax's
    unfrozen step, one JAX compile of the branch alone). Each within
    1e-6·max|g| of its tensor (`check_gradients`); the relative depth's
    output head gets none in the port and zero in JAX's."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from openstereo_tpu.models.backbones.dpt import DepthAnythingV2

    model = ts.port_model(CASE, jax_step["variables"], freeze_vit=False)
    views = []

    def keep(mod, inp, out):
        view = {"x": inp[0].detach()}
        out[0].register_hook(lambda g: view.update(ct=g))
        views.append(view)

    hook = model.feature.dino.depth_anything.register_forward_hook(keep)
    try:
        batch = ts.torch_batch(jax_step["data"])
        loss, _ = model.get_loss(model(batch), batch)
        loss.backward()
    finally:
        hook.remove()
    assert len(views) == 2 and all("ct" in v for v in views)
    assert float(loss.detach()) == port_step["loss"]

    variables = jax_step["variables"]
    with jax.enable_x64(True):
        both = lambda key: jnp.asarray(np.concatenate(  # noqa: E731
            [v[key].permute(0, 2, 3, 1).numpy() for v in views]), jnp.float64)
        branch = DepthAnythingV2(CASE.tiny["vit_size"], dtype=jnp.float64)

        def vjp(p, x, ct):
            return jax.grad(lambda q: jnp.vdot(branch.apply({"params": q}, x)[0], ct))(p)

        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                              variables["params"]["feature"]["dino"])
        g = jax.device_get(ts.run_jitted(vjp, params, both("x"), both("ct")))
    tree = jax.tree.map(np.zeros_like, variables["params"])
    tree["feature"]["dino"] = g
    dino = {k: v for k, v in CASE.to_port({"params": tree, "batch_stats": variables[
        "batch_stats"]}).items() if k.startswith(FROZEN)}
    # the relative depth's output head: the features do not reach it, so it gets no gradient
    depth_out = "feature.dino.depth_anything.depth_head.scratch.output_conv2."
    assert len(dino) > 100
    for k, g in dino.items():
        if k.startswith(depth_out):
            assert not g.any() and model.get_parameter(k).grad is None, k
        else:
            assert g.abs().max() > 0, k
    ts.check_gradients(dict(jax_step, grads={**jax_step["grads"], **dino}),
                       {"model": model, "grads": {k: None if p.grad is None else p.grad.clone()
                                                  for k, p in model.named_parameters()}},
                       frozen=(depth_out,))


def test_sequence_loss_matches_flax():
    ts.check_sequence_loss(CASE)


def test_loop_without_its_detach_leaves_the_jax_gradients(jax_step, port_step):
    ts.check_detach_matters(CASE, jax_step, port_step, DETACH_IN)


def test_train_step_updated_parameters(jax_step, port_step):
    assert port_step["opt"] == "adamw"
    ts.check_updated_parameters(jax_step, port_step)


def test_train_step_batchnorm_statistics(jax_step, port_step):
    """The 3D stem, the hourglass (the disparity transformer's patch
    BatchNorm included) and the context net each update once: no BatchNorm
    runs per view (the trunk and decoder hold LayerNorm and InstanceNorm)."""
    ts.check_batchnorm_statistics(jax_step, port_step, None, "cost_agg.conv_patch.1")
    ts.check_batchnorm_update_counts(port_step, twice=())


def test_freeze_bn_keeps_running_statistics(jax_step):
    ts.check_freeze_bn(CASE, jax_step, "cnet.norm1")


def test_eval_with_kernels_after_the_step(jax_step, port_step):
    ts.check_eval_after_step(CASE, jax_step, port_step)


def test_train_cli_runs_the_sceneflow_config_on_cpu(tmp_path, monkeypatch):
    ts.check_train_cli(CASE, tmp_path, monkeypatch)


def test_overfit_recipe_runs_two_steps():
    ts.check_overfit_recipe(CASE, "FoundationStereo",
                            {"VIT_SIZE": "vits", "TRAIN_ITERS": 2, "VALID_ITERS": 2})


def test_config_keys_reach_the_model():
    """TRAIN_ITERS, VALID_ITERS and FREEZE_VIT as the SceneFlow config sets
    them, and as changed."""
    c = load_config(str(ts.ROOT / CFG))
    model = build_model(c.MODEL, device="cpu")
    assert (model.vit_size, model.train_iters, model.valid_iters, model.feature.freeze_vit) == (
        "vits", 22, 32, True)
    c.MODEL.update(TRAIN_ITERS=5, VALID_ITERS=3, FREEZE_VIT=False)
    model = build_model(c.MODEL, device="cpu")
    assert (model.train_iters, model.valid_iters, model.feature.freeze_vit) == (5, 3, False)


def test_training_init_follows_flax_defaults():
    """`build_model(init="train")` on the SceneFlow config: the scales flax
    initialises to constants (the ViT's LayerScale 1, EdgeNeXt's layer
    scales 1e-6, XCA's temperature 1), the class token 0 and the position
    table N(0, 0.02) (`backbones/dinov2.py`, `backbones/edgenext.py`), the
    conv and linear kernels flax's truncated lecun-normal."""
    import torch

    from openstereo_tpu_torch.models.backbones.dinov2 import DinoViT, LayerScale
    from openstereo_tpu_torch.models.backbones.edgenext import XCA, ConvEncoder, SDTAEncoder

    model = build_model(load_config(str(ts.ROOT / CFG)).MODEL, device="cpu", seed=0, init="train")
    mods = dict(model.named_modules())
    scales = [m.gamma for m in mods.values() if isinstance(m, LayerScale)]
    tiny = [t for m in mods.values() if isinstance(m, (ConvEncoder, SDTAEncoder))
            for t in (m.gamma, getattr(m, "gamma_xca", m.gamma))]
    temps = [m.temperature for m in mods.values() if isinstance(m, XCA)]
    vit = next(m for m in mods.values() if isinstance(m, DinoViT))
    assert len(scales) == 24 and len(tiny) >= 9 and temps
    assert all(torch.equal(t, torch.ones_like(t)) for t in scales + temps)
    assert all(torch.equal(t, torch.full_like(t, 1e-6)) for t in tiny)
    assert not vit.cls_token.any()
    pos = vit.pos_embed.detach().double()
    assert abs(float(pos.std()) - 0.02) < 0.001 and abs(float(pos.mean())) < 0.001
    n = ts.check_flax_fan_in(ts.Case(None, FoundationStereo, {}, (0, 0), CFG, None, None),
                             lambda m: [x for x in m.modules()
                                        if isinstance(x, (torch.nn.Conv2d, torch.nn.Linear))])
    assert n > 100
