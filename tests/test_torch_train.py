"""Port training pieces vs the JAX package's, on the CPU.

The same inputs, drawn from a seed with numpy, go through the JAX function
and the port's. Tolerances:
- losses and metrics: rtol 1e-6, atol 1e-7 (f32, the same formulas);
- schedules: rtol 2e-6, atol 1e-6·peak (optax evaluates its schedules in
  f32, where `end + (start − end)/2·(cos + 1)` loses digits near a phase's
  small end, the port in f64);
- clips: rtol 1e-6, atol 1e-8; optimizers (3 steps at a peak lr of 0.05):
  rtol 1e-5, atol 1e-6, i.e. 2e-5 of a step (optax takes its schedule and
  bias corrections in f32);
- BatchNorm in training: outputs, input gradients and running statistics
  rtol 1e-5, atol 1e-6; parameter gradients rtol 1e-5, atol 1e-6·max|g| of
  the tensor (a conv weight's gradient sums cancelling terms);
- evaluation after a step, kernels on vs off (f32): atol 1e-4 px, as
  `tests/test_torch_lightstereo.py`; each path vs a fresh model: equal;
- the LightStereo train step (max_disp 16, blocks (1,1,1), expanse 2,
  32×64, batch 2, the LightStereo-S config's AdamW, OneCycleLR and clip by
  value) runs in f64 on both sides: at this size the 1/32-scale BatchNorms
  take their statistics over 4 values per channel, which amplifies f32
  rounding far beyond a 1e-5 check (the port's f32 gradients are within
  1e-2·max|g| of the exact step, `test_train_step_in_f32`, and JAX's own f32
  step rounds differently again). Tolerances: loss rtol
  1e-12; every gradient atol 1e-7·max|g| of its tensor plus 1e-12 of the
  model's largest (gradients that are zero in exact arithmetic);
  BatchNorm statistics rtol 1e-10, atol 1e-12; updated parameters atol
  1e-2·lr, since Adam's first step is sign-like where |g| is tiny. The JAX
  step is compiled once in this file.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
import optax

from openstereo_tpu.config import Config as JConfig
from openstereo_tpu.evaluation import metrics as jmetrics
from openstereo_tpu.models import layers as jl
from openstereo_tpu.models import losses as jlosses
from openstereo_tpu.models.lightstereo import LightStereo as FlaxLightStereo
from openstereo_tpu.runtime import optim as joptim

from openstereo_tpu_torch.config import Config
from openstereo_tpu_torch.evaluation import metrics as tmetrics
from openstereo_tpu_torch.models import layers as tl
from openstereo_tpu_torch.models import losses as tlosses
from openstereo_tpu_torch.models import set_kernels
from openstereo_tpu_torch.models.lightstereo import LightStereo
from openstereo_tpu_torch.runtime import optim as toptim
from openstereo_tpu_torch.utils.jax_weights import FlaxToTorch, lightstereo_state_dict_from_jax

from test_torch_layers import _random_variables
from test_torch_ops import to_nchw, to_nhwc
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
LS_CFG = yaml.safe_load((ROOT / "cfgs/lightstereo/lightstereo_s_sceneflow.yaml").read_text())


# --------------------------------------------------------------- losses, metrics

def _loss_inputs(mask_kind):
    rng = np.random.RandomState(0)
    pred = (rng.rand(2, 6, 9) * 20).astype(np.float32)
    gt = (pred + rng.randn(2, 6, 9) * 3).astype(np.float32)
    gt[0, 0, :4] = 0.0
    mask = {"random": rng.rand(2, 6, 9) > 0.4, "empty": np.zeros((2, 6, 9), bool),
            "one image empty": np.stack([rng.rand(6, 9) > 0.4, np.zeros((6, 9), bool)])}[mask_kind]
    probs = rng.rand(2, 6, 9).astype(np.float32)
    targets = (rng.rand(2, 6, 9) > 0.5).astype(np.float32)
    logits = (rng.randn(2, 5, 6) * 2).astype(np.float32)
    classes = rng.randint(0, 5, (2, 6))
    soft = rng.rand(2, 5, 6).astype(np.float32)
    soft /= soft.sum(1, keepdims=True)
    return dict(pred=pred, gt=gt, mask=mask, probs=probs, targets=targets, logits=logits,
                classes=classes, soft=soft, log_pred=np.log(soft) * 0.9)


LOSS_CASES = {
    "smooth_l1": lambda L, a: L.smooth_l1(a["pred"], a["gt"]),
    "masked_mean": lambda L, a: L.masked_mean(a["pred"], a["mask"]),
    "masked_smooth_l1": lambda L, a: L.masked_smooth_l1(a["pred"], a["gt"], a["mask"]),
    "masked_l1": lambda L, a: L.masked_l1(a["pred"], a["gt"], a["mask"]),
    "disp_valid_mask": lambda L, a: L.disp_valid_mask(a["gt"], 12.0),
    "bce": lambda L, a: L.bce(a["probs"], a["targets"]),
    "bce_with_logits": lambda L, a: L.bce_with_logits(a["pred"] - 10, a["targets"]),
    "cross_entropy classes": lambda L, a: L.cross_entropy(a["logits"], a["classes"]),
    "cross_entropy soft": lambda L, a: L.cross_entropy(a["logits"], a["soft"]),
    "kl_div mean": lambda L, a: L.kl_div(a["log_pred"], a["soft"]),
    "kl_div batchmean": lambda L, a: L.kl_div(a["log_pred"], a["soft"], "batchmean"),
    "kl_div none": lambda L, a: L.kl_div(a["log_pred"], a["soft"], "none"),
}
METRIC_CASES = {
    **{f"per-image {n}": (lambda n: lambda M, a: M.compute_metrics(
        a["pred"], a["gt"], a["mask"], (n,))[n])(n) for n in tmetrics.METRIC_FNS},
    "scalar epe": lambda M, a: M.epe_metric_scalar(a["pred"], a["gt"], a["mask"]),
    "scalar d1": lambda M, a: M.d1_metric_scalar(a["pred"], a["gt"], a["mask"]),
    "scalar bad-2": lambda M, a: M.threshold_metric_scalar(a["pred"], a["gt"], a["mask"], 2.0),
}


MASKED = {"masked_mean", "masked_smooth_l1", "masked_l1", *METRIC_CASES}
CASES = [(c, m) for c in list(LOSS_CASES) + list(METRIC_CASES)
         for m in (("random", "empty", "one image empty") if c in MASKED else ("random",))]


@pytest.mark.parametrize("case,mask_kind", CASES, ids=[f"{c}-{m}" for c, m in CASES])
def test_losses_and_metrics_match_jax(case, mask_kind):
    """Each loss and metric against JAX's; over an empty mask both give 0."""
    a = _loss_inputs(mask_kind)
    fn, jmod, tmod = ((LOSS_CASES[case], jlosses, tlosses) if case in LOSS_CASES
                      else (METRIC_CASES[case], jmetrics, tmetrics))
    ref = np.asarray(fn(jmod, {k: jnp.asarray(v) for k, v in a.items()}))
    got = fn(tmod, {k: torch.from_numpy(np.asarray(v)) for k, v in a.items()}).numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    if mask_kind == "empty":
        assert np.all(got == 0)


# --------------------------------------------------------------- optimizer, schedules

OPT = {"NUM_EPOCHS": 4, "OPTIMIZER": {"NAME": "AdamW", "LR": 2e-3, "WEIGHT_DECAY": 1e-5}}
SCHEDULERS = {
    "none": None,
    "OneCycleLR LightStereo": LS_CFG["OPTIMIZATION"]["SCHEDULER"],
    "OneCycleLR pct 0.3 div 10": {"NAME": "OneCycleLR", "MAX_LR": 4e-3, "PCT_START": 0.3,
                                  "DIV_FACTOR": 10.0, "FINAL_DIV_FACTOR": 100.0},
    "OneCycleLR pct clamped": {"NAME": "OneCycleLR", "PCT_START": 0.0},
    "MultiStepLR on epoch": {"NAME": "MultiStepLR", "MILESTONES": [1, 3], "GAMMA": 0.5},
    "MultiStepLR on step": {"NAME": "MultiStepLR", "MILESTONES": [5, 17], "ON_EPOCH": False},
    "CosineAnnealingLR": {"NAME": "CosineAnnealingLR"},
    "StepLR": {"NAME": "StepLR", "STEP_SIZE": 1, "GAMMA": 0.3},
    "ConstantLR": {"NAME": "ConstantLR"},
    "warmup steps": {"NAME": "CosineAnnealingLR", "WARMUP": {"WARM_STEPS": 7}},
    "warmup epochs": {"NAME": "MultiStepLR", "MILESTONES": [2], "WARMUP": {"WARM_EPOCHS": 1}},
}


def _opt_cfg(scheduler=None, **optimizer):
    d = {**OPT, "OPTIMIZER": {**OPT["OPTIMIZER"], **optimizer}}
    if scheduler is not None:
        d["SCHEDULER"] = scheduler
    return d


@pytest.mark.parametrize("total", [40, 6])
@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_schedule_matches_optax(name, total):
    """Every step of a short run and a few past its end."""
    d = _opt_cfg(SCHEDULERS[name])
    ref_fn = joptim.build_schedule(JConfig.from_dict(d), total)
    got_fn = toptim.build_schedule(Config.from_dict(d), total)
    steps = np.arange(total + 3)
    ref = np.array([float(ref_fn(jnp.asarray(s, jnp.int32))) for s in steps])
    got = np.array([got_fn(int(s)) for s in steps])
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(got, ref, rtol=2e-6, atol=1e-6 * ref.max())


def test_onecycle_is_not_torch_onecycle():
    """torch's OneCycleLR peaks one step earlier than optax's; the port follows optax."""
    total = 20
    d = _opt_cfg({"NAME": "OneCycleLR", "PCT_START": 0.25})
    got = [toptim.build_schedule(Config.from_dict(d), total)(s) for s in range(total)]
    opt = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=1.0)
    sched = torch.optim.lr_scheduler.OneCycleLR(opt, 2e-3, total_steps=total, pct_start=0.25,
                                                cycle_momentum=False)
    ref = []
    for _ in range(total):
        ref.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    assert int(np.argmax(got)) == 5 and int(np.argmax(ref)) == 4


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"conv": (rng.randn(3, 4, 2) * 0.5).astype(np.float32),
            "bn_scale": (1 + 0.1 * rng.randn(4)).astype(np.float32),
            "bias": (0.1 * rng.randn(5)).astype(np.float32)}


CLIPS = {"value": {"TYPE": "value", "CLIP_VALUE": 0.1},
         "norm, clipping": {"TYPE": "norm", "MAX_NORM": 0.5},
         "norm, below the limit": {"TYPE": "norm", "MAX_NORM": 100.0}}


@pytest.mark.parametrize("clip", list(CLIPS))
def test_clip_matches_optax(clip):
    g = _tree(1)
    d = {**_opt_cfg(), "CLIP_GRAD": CLIPS[clip]}
    tx, _ = joptim.build_optimizer(JConfig.from_dict(
        {**d, "OPTIMIZER": {"NAME": "SGD", "LR": 1.0}}), 10)
    params = {k: jnp.zeros_like(v) for k, v in g.items()}
    ref, _ = tx.update({k: jnp.asarray(v) for k, v in g.items()}, tx.init(params), params)
    tparams = {k: torch.nn.Parameter(torch.zeros(v.shape)) for k, v in g.items()}
    opt, _ = toptim.build_optimizer(Config.from_dict(
        {**d, "OPTIMIZER": {"NAME": "SGD", "LR": 1.0}}), 10, tparams.items())
    for k, p in tparams.items():
        p.grad = torch.from_numpy(g[k])
    got = opt._clipped()
    for k in g:
        # optax's sgd update is -lr·g
        np.testing.assert_allclose(got[k].numpy(), -np.asarray(ref[k]), rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("name,extra,zeros", [
    ("AdamW", {"WEIGHT_DECAY": 0.05}, ()), ("Adam", {}, ()), ("SGD", {"MOMENTUM": 0.9}, ()),
    ("SGD", {}, ()), ("RMSprop", {}, ()), ("Lamb", {}, ()), ("Lamb", {"WEIGHT_DECAY": 0.01}, ()),
    ("Lamb", {"WEIGHT_DECAY": 0.01}, ("bias",))],
    ids=["AdamW", "Adam", "SGD momentum", "SGD", "RMSprop", "Lamb", "Lamb weight decay",
         "Lamb zero tensor"])
def test_optimizer_matches_optax(name, extra, zeros):
    """Three steps with clip by norm and a OneCycleLR schedule; the tensors
    `zeros` start at 0 (Lamb's trust ratio is then 1 at the first step)."""
    d = {**_opt_cfg({"NAME": "OneCycleLR", "PCT_START": 0.3}, NAME=name, LR=0.05, **extra),
         "CLIP_GRAD": {"TYPE": "norm", "MAX_NORM": 2.0}}
    tx, _ = joptim.build_optimizer(JConfig.from_dict(d), 10)
    start = {k: np.zeros_like(v) if k in zeros else v for k, v in _tree(2).items()}
    params = {k: jnp.asarray(v) for k, v in start.items()}
    state = tx.init(params)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v)) for k, v in start.items()}
    opt, _ = toptim.build_optimizer(Config.from_dict(d), 10, tparams.items())
    for step in range(3):
        g = _tree(10 + step)
        g = {k: v * (3.0 if step == 1 else 0.3) for k, v in g.items()}  # clip at step 1 only
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k in g:
            np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(params[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=f"{name} step {step} {k}")
    assert opt.count == 3


def test_optimizer_refuses_unported_options():
    p = [("w", torch.nn.Parameter(torch.zeros(2)))]
    with pytest.raises(NotImplementedError, match="item 8"):
        toptim.build_optimizer(Config.from_dict(_opt_cfg(PARAM_GROUPS=[{"MATCH": "w"}])), 10, p)


# --------------------------------------------------------------- BatchNorm in training

@pytest.mark.parametrize("mode", ["train", "frozen"])
def test_bn_convblock_training_matches_flax(mode):
    """A ConvBlock with BatchNorm called twice in training (flax with a mutable
    'batch_stats', or frozen: train=True with nothing mutable): outputs,
    gradients of params and input, running statistics."""
    rng = np.random.RandomState(3)
    xs = [(rng.randn(2, 7, 9, 6) * 2 + 0.5).astype(np.float32) for _ in range(2)]
    cots = [rng.randn(2, 7, 9, 8).astype(np.float32) for _ in range(2)]
    fm = jl.ConvBlock(8, 3, norm="batch", act=jl.leaky_relu(0.2))
    v = _random_variables(fm, jnp.asarray(xs[0]), 4)
    b = FlaxToTorch(v)
    b.convbn("", "block")
    tm = tl.ConvBlock(6, 8, 3, norm="batch", act=tl.leaky_relu(0.2))
    tm.load_state_dict(b.finish())
    tm.train()
    if mode == "frozen":
        tl.freeze_bn(tm)
    params, bs = v["params"], v["batch_stats"]
    for x, cot in zip(xs, cots):
        def f(p, xx):
            out, mut = fm.apply({"params": p, "batch_stats": bs}, xx, train=True,
                                mutable=["batch_stats"] if mode == "train" else [])
            return jnp.sum(out * cot), (out, mut)

        (_, (ref, mut)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            params, jnp.asarray(x))
        bs = mut["batch_stats"] if mode == "train" else bs
        xt = to_nchw(x).requires_grad_(True)
        out = tm(xt)
        (out * to_nchw(cot)).sum().backward()
        tol = dict(rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(to_nhwc(out.detach()), np.asarray(ref), **tol)
        np.testing.assert_allclose(to_nhwc(xt.grad), np.asarray(gx), **tol)
        gb = FlaxToTorch({"params": gp, "batch_stats": bs})
        gb.convbn("", "block")
        carried = gb.finish()
        for k, p in tm.named_parameters():
            g = carried[k].numpy()
            np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-5, atol=1e-6 * np.abs(g).max(),
                                       err_msg=k)
            p.grad = None
        for k in ("block.1.running_mean", "block.1.running_var"):
            np.testing.assert_allclose(tm.state_dict()[k].numpy(), carried[k].numpy(),
                                       err_msg=k, **tol)
    if mode == "frozen":
        np.testing.assert_array_equal(tm.block[1].running_var.numpy(),
                                      np.asarray(v["batch_stats"]["bn"]["var"]))


# --------------------------------------------------------------- one LightStereo train step

H, W, MAX_DISP, TOTAL_STEPS = 32, 64, 16, 100
TINY = dict(max_disp=MAX_DISP, aggregation_blocks=(1, 1, 1), expanse_ratio=2)


def _batch():
    rng = np.random.RandomState(11)
    disp = (rng.rand(2, H, W) * 17).astype(np.float32)  # some beyond max_disp
    disp[:, :3] = 0.0  # and some invalid rows
    return {"left": rng.randn(2, H, W, 3).astype(np.float32),
            "right": rng.randn(2, H, W, 3).astype(np.float32), "disp": disp}


@pytest.fixture(scope="module")
def jax_step():
    """The JAX train step (the JAX trainer's loss and optax chain from the
    LightStereo-S config) in f64, jitted once: (variables, batch, loss,
    grads, updated variables)."""
    data = _batch()
    with jax.enable_x64(True):
        jdata = {k: jnp.asarray(v, jnp.float64) for k, v in data.items()}
        model = FlaxLightStereo(**TINY, dtype=jnp.float64)
        variables = jax.tree.map(lambda a: np.asarray(a, np.float64),
                                 _random_variables(model, jdata, 21, train=True))
        tx, _ = joptim.build_optimizer(JConfig.from_dict(LS_CFG).OPTIMIZATION, TOTAL_STEPS)

        @jax.jit
        def step(params, bs, batch):
            def loss_fn(p):
                out, mut = model.apply({"params": p, "batch_stats": bs}, batch, train=True,
                                       mutable=["batch_stats"])
                return model.get_loss(out, batch)[0], mut["batch_stats"]

            (loss, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            updates, _ = tx.update(grads, tx.init(params), params)
            return loss, grads, optax.apply_updates(params, updates), new_bs

        loss, grads, new_params, new_bs = jax.device_get(
            step(variables["params"], variables["batch_stats"], jdata))
    assert np.asarray(loss).dtype == np.float64
    return dict(variables=variables, data=data, loss=float(loss),
                grads=lightstereo_state_dict_from_jax({"params": grads, "batch_stats": new_bs}),
                after=lightstereo_state_dict_from_jax({"params": new_params,
                                                       "batch_stats": new_bs}))


def _port_model(variables, freeze=False, dtype=torch.float64):
    """The port's model from flax variables, in training mode; parameters in
    f32 (f64 for an f64 model), `dtype` the compute dtype."""
    m = LightStereo(**TINY, dtype=dtype)
    if dtype == torch.float64:
        m = m.double()
    m.load_state_dict(lightstereo_state_dict_from_jax(variables))
    m.train()
    return tl.freeze_bn(m) if freeze else m


def _torch_batch(data, dtype=torch.float64):
    return {"left": to_nchw(data["left"]).to(dtype), "right": to_nchw(data["right"]).to(dtype),
            "disp": torch.from_numpy(data["disp"]).to(dtype)}


@pytest.fixture(scope="module")
def port_step(jax_step):
    """The port's step on the same variables and batch: (model, loss, grads, lr)."""
    model = _port_model(jax_step["variables"])
    opt, schedule = toptim.build_optimizer(Config.from_dict(LS_CFG).OPTIMIZATION, TOTAL_STEPS,
                                           model.named_parameters())
    batch = _torch_batch(jax_step["data"])
    loss, _ = model.get_loss(model(batch), batch)
    loss.backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    opt.step()
    return dict(model=model, loss=float(loss.detach()), grads=grads, lr=schedule(0))


def test_train_step_loss(jax_step, port_step):
    print(f"LightStereo train loss: port {port_step['loss']!r}, JAX {jax_step['loss']!r}")
    np.testing.assert_allclose(port_step["loss"], jax_step["loss"], rtol=1e-12)


def test_train_step_gradients(jax_step, port_step):
    """Every gradient within 1e-7·max|g| of its tensor, plus 1e-12 of the
    largest gradient of the model: the biases of a BatchNorm that feeds
    another BatchNorm have a zero gradient in exact arithmetic, ~1e-15 here."""
    ref = jax_step["grads"]
    floor = 1e-12 * max(np.abs(ref[k].numpy()).max() for k in port_step["grads"])
    worst = 0.0
    for k, g in port_step["grads"].items():
        r = ref[k].numpy()
        scale = np.abs(r).max()
        err = np.abs(g.numpy() - r).max()
        if scale > 1e3 * floor:
            worst = max(worst, err / scale)
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-7 * scale + floor, err_msg=k)
    print(f"{len(port_step['grads'])} gradients, worst max-abs {worst:.3g}·max|g|")
    assert set(port_step["grads"]) == {k for k, _ in port_step["model"].named_parameters()}


def test_train_step_updated_parameters(jax_step, port_step):
    after, lr = jax_step["after"], port_step["lr"]
    for k, p in port_step["model"].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), after[k].numpy(), rtol=0,
                                   atol=1e-2 * lr, err_msg=k)


def test_train_step_batchnorm_statistics(jax_step, port_step):
    """Two updates per trunk BatchNorm (left view, then right) and one per other."""
    sd = port_step["model"].state_dict()
    keys = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(keys) > 100
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), jax_step["after"][k].numpy(), rtol=1e-10,
                                   atol=1e-12, err_msg=k)
    assert int(sd["backbone.bn1.num_batches_tracked"]) == 2
    assert int(sd["stem_2.0.block.1.num_batches_tracked"]) == 1


def test_freeze_bn_keeps_running_statistics(jax_step):
    model = _port_model(jax_step["variables"], freeze=True)
    before = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    batch = _torch_batch(jax_step["data"])
    loss, _ = model.get_loss(model(batch), batch)
    loss.backward()
    sd = model.state_dict()
    for k, v in before.items():
        assert torch.equal(sd[k], v), k
    bn = model.backbone.bn1
    assert bn.weight.grad.abs().sum() > 0 and bn.bias.grad.abs().sum() > 0


@pytest.mark.parametrize("freeze", [False, True], ids=["BN training", "FREEZE_BN"])
def test_eval_with_kernels_sees_the_step(jax_step, freeze):
    """Evaluate with kernels on and off (folding BN per weight version), take a
    train step, and evaluate again: both paths must equal those of a fresh
    model loaded with the stepped weights (no cache), so no fold is stale, and
    the kernel path (on the CPU, the plain versions with folded weights) must
    equal the eager path. With FREEZE_BN only the parameters change, so only
    their version counters can refresh a fold. f32, the kernels' dtype that
    the CPU runs in seconds (bf16 casts: `test_compute_weight_cache_follows_version`)."""
    dtype = torch.float32
    model = _port_model(jax_step["variables"], freeze=freeze, dtype=dtype)
    batch = _torch_batch(jax_step["data"], dtype=torch.float32)

    def evaluate(m, kernels):
        set_kernels(m.eval(), kernels)
        with torch.inference_mode():
            return m(batch)["disp_pred"].clone()

    before = evaluate(model, True), evaluate(model, False)
    opt, _ = toptim.build_optimizer(Config.from_dict(LS_CFG).OPTIMIZATION, TOTAL_STEPS,
                                    model.named_parameters())
    model.train()
    if freeze:
        tl.freeze_bn(model)
    loss, _ = model.get_loss(model(batch), batch)
    loss.backward()
    opt.step()
    wired, eager = evaluate(model, True), evaluate(model, False)
    fresh = LightStereo(**TINY, dtype=dtype)
    fresh.load_state_dict(model.state_dict())
    assert torch.equal(wired, evaluate(fresh, True)) and torch.equal(eager, evaluate(fresh, False))
    moved = min((wired - before[0]).abs().max(), (eager - before[1]).abs().max()).item()
    print(f"after a step: kernel vs eager max-abs {(wired - eager).abs().max().item():.3g} px, "
          f"moved {moved:.3g} px")
    assert moved > 1e-2
    np.testing.assert_allclose(wired.numpy(), eager.numpy(), rtol=0, atol=1e-4)


def test_train_step_in_f32(jax_step, port_step):
    """The port's f32 step against the f64 reference (JAX's step in f64): the
    loss within 1e-5, the gradients within 1e-2·max|g| of their tensor. The
    bound is loose for what it is: at this size the 1/32-scale BatchNorms
    take their statistics over 4 values per channel, which amplifies f32
    rounding; the printed figure is the port's own f32 error."""
    model = _port_model(jax_step["variables"], dtype=torch.float32)
    batch = _torch_batch(jax_step["data"], dtype=torch.float32)
    loss, _ = model.get_loss(model(batch), batch)
    loss.backward()
    worst = 0.0
    for k, p in model.named_parameters():
        ref = port_step["grads"][k].numpy()
        scale = np.abs(ref).max()
        if scale > 1e-9:
            worst = max(worst, np.abs(p.grad.double().numpy() - ref).max() / scale)
    print(f"f32 step vs f64: loss {float(loss.detach())!r} vs {jax_step['loss']!r}, gradients "
          f"worst max-abs {worst:.3g}·max|g|")
    np.testing.assert_allclose(float(loss.detach()), jax_step["loss"], rtol=1e-5)
    assert worst < 1e-2
