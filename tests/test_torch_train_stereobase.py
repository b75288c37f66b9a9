"""StereoBase training in the port vs the JAX package's, on the CPU.

One train step of a tiny StereoBase as its config builds it (32×64,
max_disp 32, gwc + concat volume with 8 concat channels, 3 train
iterations; every width as the config's: hidden dims 128, 3 GRU layers
without slow-fast updates, 2 correlation levels, radius 4) in f64 on both
sides, with the StereoBase config's AdamW, OneCycleLR and clip by value,
against JAX's `value_and_grad` of the flax StereoBase compiled once
(`tests/torch_train_step.py` has the protocol and the tolerances; the size
is the IGEV file's). The step holds the per-view trunk, stems and
`concat_conv` (each BatchNorm updated twice), the GRU loop under autograd
with the carried disparity detached, every iterate folded into
`spx_2_gru`'s batch, the training heads and the sequence loss. The
four-volume variant's one module of its own, `InterlacedVolume`, is held
in training against flax's in f64 on its own (its inference test's 4
channels at 1/4 of 32×64, the variables drawn in the tree that the JAX
converter makes of the four-volume model): the output, the gradients of
its parameters and inputs, and its BatchNorms' statistics over every
shift, one update each; a small JAX compile, where the whole variant's
step would take a second one of the model. Also: `get_loss`
alone against flax's; the loop without its detach leaves JAX's gradients;
FREEZE_BN; the evaluation with kernels on and off
after the step; the training CLI on both StereoBase configs (SceneFlow and
KITTI) and the overfit recipe; the configs' TRAIN_ITERS and EVAL_ITERS
reaching the model.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openstereo_tpu.models.stereobase import StereoBase as FlaxStereoBase
from openstereo_tpu.models.stereobase.stereobase import InterlacedVolume as FlaxInterlacedVolume
from openstereo_tpu.utils.torch_convert import convert_stereobase

from openstereo_tpu_torch.config import load_config
from openstereo_tpu_torch.models import build_model
from openstereo_tpu_torch.models.stereobase import StereoBase
from openstereo_tpu_torch.models.stereobase.stereobase import InterlacedVolume
from openstereo_tpu_torch.utils import jax_weights as jw

import torch_train_step as ts
from test_torch_layers import _random_like
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

GWC_CONCAT = dict(max_disp=32, use_concat_volume=True, concat_channels=8, train_iters=3,
                  eval_iters=2)
CASE = ts.Case(FlaxStereoBase, StereoBase, GWC_CONCAT, (32, 64),
               "cfgs/stereobase/stereobase_sceneflow.yaml", jw.stereobase_state_dict_from_jax,
               convert_stereobase, crop=(32, 64), pad=(64, 96))
FOUR = dict(GWC_CONCAT, use_sub_volume=True, use_interlaced_volume=True, interlaced_channels=4)
BACKBONE_BN = "feature.bn1"
PER_VIEW = ("feature.", "concat_conv.")
CFGS = sorted(str(p.relative_to(ts.ROOT)) for p in (ts.ROOT / "cfgs/stereobase").glob("*.yaml"))


@pytest.fixture(scope="module")
def both():
    return ts.steps(CASE)


@pytest.fixture(scope="module")
def jax_step(both):
    return both[0]


@pytest.fixture(scope="module")
def port_step(both):
    return both[1]


def interlaced_to_port(variables):
    """flax InterlacedVolume variables → the port module's state_dict (the
    mapping `jw.stereobase_state_dict_from_jax` makes under
    `build_interlaced_volume`)."""
    b = jw.FlaxToTorch(variables)
    for i in range(3):
        b.convbn(f"c{i}", f"conv3d.{i}.block")
    b.convbn("volume11", "volume11.block")
    return b.finish()


@pytest.fixture(scope="module")
def interlaced():
    """`InterlacedVolume` in training, f64 on both sides: JAX's
    `value_and_grad` of <output, a random cotangent> over the parameters and
    both inputs with mutable `batch_stats` (`ts.run_jitted`), and the port's
    forward and backward; inputs [2, 96, 8, 16], D 8."""
    tree = convert_stereobase({k: v.numpy() for k, v in StereoBase(**FOUR).state_dict().items()})
    variables = _random_like({c: tree[c]["build_interlaced_volume"] for c in tree}, 32)
    b, c, h, w, d, f = 2, 96, 8, 16, FOUR["max_disp"] // 4, FOUR["interlaced_channels"]
    rng = np.random.RandomState(12)
    left, right = rng.randn(2, b, h, w, c)
    cot = rng.randn(b, d, h, w, f)
    with jax.enable_x64(True):
        mod = FlaxInterlacedVolume(num_features=f, dtype=jnp.float64)
        v = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)

        def value(params, l, r):
            out, mut = mod.apply({"params": params, "batch_stats": v["batch_stats"]}, l, r, d,
                                 train=True, mutable=["batch_stats"])
            return jnp.sum(out * cot), (out, mut["batch_stats"])

        (_, (out, new_bs)), (g, gl, gr) = jax.device_get(ts.run_jitted(
            jax.value_and_grad(value, argnums=(0, 1, 2), has_aux=True), v["params"],
            jnp.asarray(left), jnp.asarray(right)))
    ref = dict(out=np.asarray(out), inputs=[np.asarray(gl), np.asarray(gr)],
               grads=interlaced_to_port({"params": g, "batch_stats": new_bs}), norm=float("nan"),
               max_norm=float("nan"))
    port = InterlacedVolume(f).double().train()
    port.load_state_dict(interlaced_to_port(variables))
    views = [torch.from_numpy(a).permute(0, 3, 1, 2).requires_grad_() for a in (left, right)]
    got_out = port(*views, d)
    (got_out * torch.from_numpy(cot).permute(0, 4, 1, 2, 3)).sum().backward()
    got = dict(model=port, out=np.moveaxis(got_out.detach().numpy(), 1, -1),
               inputs=[np.moveaxis(x.grad.numpy(), 1, -1) for x in views],
               grads={k: p.grad for k, p in port.named_parameters()})
    return ref, got


def test_train_step_loss(jax_step, port_step):
    ts.check_loss(jax_step, port_step, "StereoBase")


def test_train_step_gradients(jax_step, port_step):
    ts.check_gradients(jax_step, port_step)


def test_sequence_loss_matches_flax():
    ts.check_sequence_loss(CASE)


def test_loop_without_its_detach_leaves_the_jax_gradients(jax_step, port_step):
    ts.check_detach_matters(CASE, jax_step, port_step)


def test_train_step_updated_parameters(jax_step, port_step):
    assert port_step["opt"] == "adamw"
    ts.check_updated_parameters(jax_step, port_step)


def test_train_step_batchnorm_statistics(jax_step, port_step):
    ts.check_batchnorm_statistics(jax_step, port_step, "concat_conv.0.block.1",
                                  "spx_2_gru.conv1.block.1")
    ts.check_batchnorm_update_counts(port_step, PER_VIEW)


@pytest.mark.parametrize("check", ["output", "gradients", "input gradients",
                                   "batchnorm statistics"])
def test_interlaced_volume_in_training(interlaced, check):
    """The four-volume variant's `InterlacedVolume` in training against
    flax's: the output (the columns out of frame zero) within 1e-10 of its
    largest magnitude; the parameters' and inputs' gradients within
    1e-6·max|g| of each tensor; its BatchNorms' running statistics over all
    D·B shifts within rtol 1e-10, each updated once."""
    ref, got = interlaced
    if check == "output":
        np.testing.assert_allclose(got["out"], ref["out"], rtol=0,
                                   atol=1e-10 * np.abs(ref["out"]).max())
        assert not ref["out"][:, 1:, :, :1].any()
    elif check == "gradients":
        ts.check_gradients(ref, got)
    elif check == "input gradients":
        for g, r in zip(got["inputs"], ref["inputs"]):
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-6 * np.abs(r).max())
    else:
        sd = got["model"].state_dict()
        stats = [k for k in sd if k.endswith(("running_mean", "running_var"))]
        assert len(stats) == 8
        for k in stats:
            np.testing.assert_allclose(sd[k].numpy(), ref["grads"][k].double().numpy(),
                                       rtol=1e-10, atol=1e-12, err_msg=k)
        assert all(int(v) == 1 for k, v in sd.items() if k.endswith("num_batches_tracked"))


def test_freeze_bn_keeps_running_statistics(jax_step):
    ts.check_freeze_bn(CASE, jax_step, BACKBONE_BN)


def test_eval_with_kernels_after_the_step(jax_step, port_step):
    ts.check_eval_after_step(CASE, jax_step, port_step)


@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: Path(c).stem)
def test_train_cli_runs_the_stereobase_configs_on_cpu(tmp_path, monkeypatch, cfg):
    ts.check_train_cli(CASE, tmp_path, monkeypatch, cfg=cfg)


def test_overfit_recipe_runs_two_steps():
    ts.check_overfit_recipe(CASE, "StereoBaseGRU", {"USE_CONCAT_VOLUME": True, "CONCAT_CHANNELS": 8,
                                         "TRAIN_ITERS": 2, "EVAL_ITERS": 2})


@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: Path(c).stem)
def test_config_keys_reach_the_model(cfg):
    """TRAIN_ITERS and EVAL_ITERS as the config sets them (TRAIN_ITERS was
    dropped before)."""
    c = load_config(str(ts.ROOT / cfg))
    model = build_model(c.MODEL, device="cpu")
    assert (model.train_iters, model.eval_iters, model.valid_iters) == (22, 32, 32)
    c.MODEL.update(TRAIN_ITERS=5)
    assert build_model(c.MODEL, device="cpu").train_iters == 5
