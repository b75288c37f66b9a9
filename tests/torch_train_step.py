"""One train step of a port model against the JAX package's, on the CPU: the
shared part of `tests/test_torch_train_{gwcnet,psmnet,coex,msnet3d,msnet2d,cfnet,
casgwcnet,caspsmnet,fadnet,igev,igev_rt,stereobase,igevpp,foundationstereo,
fastfoundationstereo,monster}.py`.

A tiny model (the eval tests' sizes) with flax variables drawn with numpy in
the tree that the JAX converter makes of the port's state_dict
(`_random_variables_via`), one batch of 2 drawn from a seed, and the
model's config's OPTIMIZATION without its warm-up (whose lr at the first
step is 0), its clip by norm set at half the gradient's global norm so that
it acts. Both sides run in f64: JAX's `value_and_grad` of the flax model
with `train=True` and mutable `batch_stats`, then the JAX trainer's optax
chain, compiled once per file (`run_jitted`); the port's forward,
`get_loss`, backward and optimizer step.

Tolerances (as `tests/test_torch_train.py` and `tests/test_torch_sttr_train.py`):
loss rtol 1e-8; each parameter's gradient atol 1e-6·max|g| of its tensor
plus 1e-12 of the model's largest (the biases of a BatchNorm that feeds
another BatchNorm have a zero gradient in exact arithmetic); the parameters
after the clipped step atol 1e-2·lr (Adam's and RMSprop's first steps are
sign-like where |g| is tiny; under Lamb a tensor with a zero gradient moves
by lr·‖p‖ along rounding noise, `check_updated_parameters`); BatchNorm
running statistics rtol 1e-10, atol 1e-12, with one update per view for a
backbone BatchNorm.
"""

import shutil
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import yaml

import jax
import jax.numpy as jnp
import optax

from openstereo_tpu.config import Config as JConfig
from openstereo_tpu.runtime import optim as joptim

from openstereo_tpu_torch.config import Config
from openstereo_tpu_torch.models import layers as tl
from openstereo_tpu_torch.models import set_kernels
from openstereo_tpu_torch.runtime import optim as toptim

from test_torch_layers import _random_variables_via
from test_torch_ops import to_nchw

ROOT = Path(__file__).resolve().parents[1]
TOTAL_STEPS = 100


@dataclass
class Case:
    """A model under test: its flax and port classes, the tiny constructor
    arguments both take, the input size, its config, the JAX→port and
    port→JAX converters, and the sizes of its run through the training CLI."""
    flax_model: type
    port_model: type
    tiny: Dict
    hw: Tuple[int, int]
    cfg: str
    to_port: Callable
    to_jax: Callable
    crop: Tuple[int, int] = (32, 64)  # the training CLI's crop and pad
    pad: Tuple[int, int] = (48, 80)
    seed: int = 31

    def config(self) -> Dict:
        return yaml.safe_load((ROOT / self.cfg).read_text())


def make_batch(case: Case) -> Dict[str, np.ndarray]:
    """A batch of 2 (NHWC images): the right view the left shifted by 3 px
    plus noise; disparities up to max_disp + 1 (some beyond it) with
    invalid top rows."""
    rng = np.random.RandomState(11)
    h, w = case.hw
    left = rng.randn(2, h, w, 3).astype(np.float32)
    right = (np.roll(left, -3, axis=2) + 0.3 * rng.randn(2, h, w, 3)).astype(np.float32)
    disp = (rng.rand(2, h, w) * (case.tiny["max_disp"] + 1)).astype(np.float32)
    disp[:, :3] = 0.0
    return {"left": left, "right": right, "disp": disp}


def torch_batch(data, dtype=torch.float64):
    return {"left": to_nchw(data["left"]).to(dtype), "right": to_nchw(data["right"]).to(dtype),
            "disp": torch.from_numpy(data["disp"]).to(dtype)}


def opt_cfg(case: Case, max_norm: Optional[float]) -> Dict:
    """The config's OPTIMIZATION without the warm-up; a clip by norm at
    `max_norm`."""
    opt = case.config()["OPTIMIZATION"]
    opt["SCHEDULER"].pop("WARMUP", None)
    clip = opt.get("CLIP_GRAD")
    if clip and clip.get("TYPE", "norm") == "norm":
        clip["MAX_NORM"] = max_norm
    return opt


def run_jitted(fn, *args):
    """fn(*args) jitted, XLA:CPU's backend at optimisation level 1 without
    LLVM's expensive passes: for these f64 train steps the fastest compile
    and run together (level 0 compiles faster but runs the f64 convs ~10x
    slower, 12 + 24 s against 18 + 3 s for GwcNet's grad; the default
    compiles slower)."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 1, "xla_llvm_disable_expensive_passes": True})(*args)


def steps(case: Case, variants: Optional[Dict[str, Dict]] = None) -> Tuple[Dict, Dict]:
    """(JAX step, port step) in f64 on the same variables and batch. The
    port's gradients come first: half their global norm is the clip by norm
    of both optimizers. JAX's: loss, gradients and stepped variables as port
    state_dicts. The port's: the stepped model, loss, gradients, lr.
    `variants` (name → constructor arguments over `case.tiny`) adds, under
    "variants", each variant model's loss and gradients on the same
    variables and batch, JAX's in the same compile as the step (`variant`)."""
    variants = variants or {}
    variables = _random_variables_via(case.to_jax, case.port_model(**case.tiny), case.seed)
    data = make_batch(case)
    got = port_grads(case, {"variables": variables, "data": data})
    norm = float(torch.sqrt(sum((g ** 2).sum() for g in got["grads"].values() if g is not None)))
    max_norm = 0.5 * norm
    opt, schedule = toptim.build_optimizer(Config.from_dict(opt_cfg(case, max_norm)),
                                           TOTAL_STEPS, got["model"].named_parameters())
    got["before"] = {k: p.detach().clone() for k, p in got["model"].named_parameters()}
    opt.step()
    got.update(lr=schedule(0), opt=opt.name, optimizer=opt,
               variants={n: port_grads(case, {"variables": variables, "data": data}, **kw)
                         for n, kw in variants.items()})

    with jax.enable_x64(True):
        flax_model = case.flax_model(**case.tiny, dtype=jnp.float64)
        models = {n: case.flax_model(**case.tiny, **kw, dtype=jnp.float64)
                  for n, kw in variants.items()}
        v = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        jdata = {k: jnp.asarray(a, jnp.float64) for k, a in data.items()}
        tx, _ = joptim.build_optimizer(JConfig.from_dict(opt_cfg(case, max_norm)), TOTAL_STEPS)

        def grads(model, params, bs, batch):
            def loss_fn(p):
                out, mut = model.apply({"params": p, "batch_stats": bs}, batch, train=True,
                                       mutable=["batch_stats"])
                return model.get_loss(out, batch)[0], mut["batch_stats"]

            return jax.value_and_grad(loss_fn, has_aux=True)(params)

        def step(params, bs, batch):
            (loss, new_bs), g = grads(flax_model, params, bs, batch)
            updates, _ = tx.update(g, tx.init(params), params)
            return (loss, g, new_bs, optax.apply_updates(params, updates),
                    {n: grads(m, params, bs, batch) for n, m in models.items()})

        loss, g, new_bs, after, extra = jax.device_get(
            run_jitted(step, v["params"], v["batch_stats"], jdata))
    assert np.asarray(loss).dtype == np.float64
    ref = dict(variables=variables, data=data, loss=float(loss), norm=norm, max_norm=max_norm,
               grads=case.to_port({"params": g, "batch_stats": new_bs}),
               after=case.to_port({"params": after, "batch_stats": new_bs}),
               variants={n: dict(loss=float(vl), grads=case.to_port({"params": vg,
                                                                     "batch_stats": vbs}))
                         for n, ((vl, vbs), vg) in extra.items()})
    return ref, got


def variant(ref: Dict, got: Dict, name: str) -> Tuple[Dict, Dict]:
    """The (JAX, port) records of `steps`' variant `name`, in the form that
    `check_loss` and `check_gradients` read."""
    r = dict(ref["variants"][name], norm=ref["norm"], max_norm=ref["max_norm"])
    return r, got["variants"][name]


def port_model(case: Case, variables, **kwargs):
    """The port's model in f64 and in training mode with `variables`."""
    m = case.port_model(**case.tiny, **kwargs, dtype=torch.float64).double()
    m.load_state_dict(case.to_port(variables))
    return m.train()


def port_grads(case: Case, ref: Dict, **kwargs) -> Dict:
    """The port's forward, loss and backward in f64 on `ref`'s variables and
    batch: model, loss, gradients (None where a parameter got none)."""
    model = port_model(case, ref["variables"], **kwargs)
    batch = torch_batch(ref["data"])
    loss, _ = model.get_loss(model(batch), batch)
    loss.backward()
    return dict(model=model, loss=float(loss.detach()),
                grads={k: None if p.grad is None else p.grad.clone()
                       for k, p in model.named_parameters()})


def check_loss(ref, got, name):
    print(f"{name} train loss: port {got['loss']!r}, JAX {ref['loss']!r}")
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-8)


def check_gradients(ref, got, frozen=()):
    """Every parameter has a gradient but those under the prefixes `frozen` (a
    frozen branch: none in the port, exactly zero in JAX's, checked by
    `check_frozen_branch`); the names are the JAX gradients'; each within
    1e-6·max|g| of its tensor + 1e-12 of the model's largest."""
    params = {k for k, _ in got["model"].named_parameters()}
    assert set(got["grads"]) == params
    assert params == {k for k in ref["grads"] if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))}
    missing = [k for k, g in got["grads"].items() if g is None and not k.startswith(frozen)]
    assert not missing, missing
    scale = max(float(ref["grads"][k].abs().max()) for k in params)
    worst = 0.0
    for k, g in got["grads"].items():
        if k.startswith(frozen):
            continue
        r = ref["grads"][k].double().numpy()
        rmax = np.abs(r).max()
        if rmax > 1e-9 * scale:
            worst = max(worst, np.abs(g.numpy() - r).max() / rmax)
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-6 * rmax + 1e-12 * scale,
                                   err_msg=k)
    print(f"{len(params)} gradients, worst max-abs {worst:.3g}·max|g| of its tensor; global "
          f"norm {ref['norm']:.4g}, clip by norm at {ref['max_norm']:.4g} where the config clips "
          f"by norm")


def check_updated_parameters(ref, got):
    """Each stepped parameter within 1e-2·lr of JAX's. Under Lamb, a tensor
    whose gradient is zero in exact arithmetic (JAX's at most 1e-9·max|g| of
    the model: the bias of a conv that a training BatchNorm follows) moves
    along its gradient's rounding noise, whose direction the two packages
    do not share: the trust ratio scales any nonzero update to ‖p‖, so it
    moves by lr·‖p‖ in both (checked to rtol 1e-9, in the port and in JAX),
    in a direction neither derives from the loss."""
    scale = max(float(ref["grads"][k].abs().max()) for k in got["grads"])
    lr = got["lr"]
    noise = 0
    for k, p in got["model"].named_parameters():
        if got["opt"] == "lamb" and float(ref["grads"][k].abs().max()) <= 1e-9 * scale:
            before = got["before"][k]
            for after in (p.detach(), ref["after"][k].double()):
                np.testing.assert_allclose(float((after - before).norm()),
                                           lr * float(before.norm()), rtol=1e-9, err_msg=k)
            noise += 1
            continue
        np.testing.assert_allclose(p.detach().numpy(), ref["after"][k].double().numpy(), rtol=0,
                                   atol=1e-2 * lr, err_msg=k)
    if noise:
        print(f"{noise} tensors with a zero gradient moved by lr·‖p‖ in both packages")


def check_batchnorm_statistics(ref, got, per_view: Optional[str], once: str):
    """Every running statistic as flax's after the step; `per_view`, a
    backbone BatchNorm, updated twice (left, then right; None where no
    BatchNorm runs per view), `once` once."""
    sd = got["model"].state_dict()
    keys = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(keys) > 20
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), ref["after"][k].double().numpy(), rtol=1e-10,
                                   atol=1e-12, err_msg=k)
    if per_view is not None:
        assert int(sd[f"{per_view}.num_batches_tracked"]) == 2
    assert int(sd[f"{once}.num_batches_tracked"]) == 1


def check_batchnorm_update_counts(got, twice=("feature.",), thrice=()):
    """Every BatchNorm of the stepped model updated its running statistics
    twice (left, then right) where its key starts with one of `twice` (the
    per-view trunk), three times where with one of `thrice` (MonSter's
    `spx_2_gru`: its three folded upsamples), else once: the IGEV family's
    context net, volume stems, hourglasses and `spx_2_gru`, whose one update
    covers every iterate folded into its batch."""
    sd = got["model"].state_dict()
    counts = {k[:-len(".num_batches_tracked")]: int(v) for k, v in sd.items()
              if k.endswith("num_batches_tracked")}
    want = {k: 2 if k.startswith(tuple(twice)) else 3 if k.startswith(tuple(thrice)) else 1
            for k in counts}
    assert counts == want, {k: v for k, v in counts.items() if v != want[k]}
    print(f"{len(counts)} BatchNorms: {sum(v == 3 for v in counts.values())} updated three "
          f"times, {sum(v == 2 for v in counts.values())} twice, "
          f"{sum(v == 1 for v in counts.values())} once")


def check_detach_matters(case: Case, ref, got, modules=("igev.igev",)):
    """The control of the IGEV family's GRU loop: with `carried` (the detach of
    the carried disparity) made the identity in each of `modules` (under
    `openstereo_tpu_torch.models`; each model module binds its own by
    import), the gradient flows through the carried disparity, and some
    gradient leaves JAX's by more than `check_gradients`' tolerance; the
    loss stays the same."""
    import importlib

    mods = [importlib.import_module(f"openstereo_tpu_torch.models.{m}") for m in modules]
    saved = [mod.carried for mod in mods]
    for mod in mods:
        mod.carried = lambda disp: disp
    try:
        ctl = port_grads(case, ref)
    finally:
        for mod, fn in zip(mods, saved):
            mod.carried = fn
    assert abs(ctl["loss"] - got["loss"]) <= 1e-12 * abs(got["loss"])
    beyond = [k for k, g in ctl["grads"].items()
              if g is not None and not np.allclose(
                  g.numpy(), ref["grads"][k].double().numpy(), rtol=0,
                  atol=1e-6 * float(ref["grads"][k].abs().max()))]
    print(f"without the detach: {len(beyond)} of {len(ctl['grads'])} gradients beyond 1e-6·max|g| "
          f"of JAX's")
    assert beyond


def check_sequence_loss(case: Case, n_init: int = 1, **kwargs):
    """The model's `get_loss` alone (its masks and weights) against flax's on
    the same random predictions and a ground truth of -5..300 px (past
    max_disp, IGEV-RT's 192 gate and IGEV++'s caps), 3 iterates, f64: rtol
    1e-12. `kwargs` over `case.tiny` (a MAX_DISP above 192, other caps)."""
    kw = {**case.tiny, **kwargs}
    rng = np.random.RandomState(7)
    shape = (2, 8, 16)
    gt = rng.uniform(-5.0, 300.0, shape)
    gt[:, :2] = 0.0
    init = [rng.uniform(0.0, 300.0, shape) for _ in range(n_init)]
    preds = [rng.uniform(0.0, 300.0, shape) for _ in range(3)]
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    got, _ = case.port_model(**kw).get_loss(
        {"init_disp": [t(a) for a in init] if n_init > 1 else t(init[0]),
         "disp_preds": [t(a) for a in preds]}, {"disp": t(gt)})
    with jax.enable_x64(True):
        j = lambda a: jnp.asarray(a, jnp.float64)  # noqa: E731
        ref, _ = case.flax_model(**kw).get_loss(
            {"init_disp": [j(a) for a in init] if n_init > 1 else j(init[0]),
             "disp_preds": [j(a) for a in preds]}, {"disp": j(gt)})
    print(f"get_loss alone: port {float(got)!r}, JAX {float(ref)!r}")
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-12)


def check_training_outputs(model, batch, n_init: int = 1, n_preds: Optional[int] = None):
    """A training forward gives 'init_disp' (`n_init` of them) and `n_preds`
    (default: the model's `train_iters`) 'disp_preds', each of the images'
    [B,H,W], the last 'disp_pred'."""
    out = model.train()(batch)
    b, _, h, w = batch["left"].shape
    init = out["init_disp"] if n_init > 1 else [out["init_disp"]]
    assert len(init) == n_init
    assert len(out["disp_preds"]) == (model.train_iters if n_preds is None else n_preds)
    for t in init + out["disp_preds"]:
        assert t.shape == (b, h, w) and torch.isfinite(t).all()
    assert out["disp_pred"] is out["disp_preds"][-1]
    return out


def check_frozen_branch(ref, got, frozen, n_frozen: int):
    """A frozen branch (the parameters under the prefixes `frozen`, `n_frozen`
    of them): no gradient in the port (it runs under `torch.no_grad()`),
    exactly zero in JAX's (its `stop_gradient`); the step moves each by
    AdamW's decay alone, p·(1 − lr·wd), in both packages, as optax's
    `adamw` moves a zero-gradient leaf; the other parameters have
    gradients."""
    opt = got["optimizer"]
    lr, wd = got["lr"], opt.weight_decay
    assert opt.name == "adamw" and wd > 0
    names = [k for k in got["grads"] if k.startswith(frozen)]
    assert len(names) == n_frozen
    for k in names:
        assert got["grads"][k] is None, k
        assert not ref["grads"][k].any(), k
        want = got["before"][k] * (1.0 - lr * wd)
        for after in (got["model"].get_parameter(k).detach(), ref["after"][k].double()):
            np.testing.assert_allclose(after.numpy(), want.numpy(), rtol=1e-12, atol=1e-300,
                                       err_msg=k)
    others = [k for k, g in got["grads"].items() if not k.startswith(frozen)]
    assert others and all(got["grads"][k] is not None for k in others)
    print(f"{len(names)} frozen tensors: no gradient in the port, zero in JAX's, both moved by "
          f"the decay alone (lr {lr:.3g}, wd {wd:g}); {len(others)} trained")


def check_freeze_bn(case: Case, ref, bn: str):
    """FREEZE_BN: the running statistics stay; the BatchNorm `bn` still gets
    gradients for its scale and bias."""
    model = tl.freeze_bn(port_model(case, ref["variables"]))
    before = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    batch = torch_batch(ref["data"])
    loss, _ = model.get_loss(model(batch), batch)
    loss.backward()
    sd = model.state_dict()
    for k, v in before.items():
        assert torch.equal(sd[k], v), k
    norm = model.get_submodule(bn)
    assert norm.weight.grad.abs().sum() > 0 and norm.bias.grad.abs().sum() > 0


def check_eval_after_step(case: Case, ref, got, atol=1e-4):
    """The stepped weights in an f32 model, evaluated with kernels on and off
    (on the CPU the wrappers run their plain versions; K2's with the
    BatchNorms folded): the same disparities within `atol` px, as
    `tests/test_torch_train.py` holds LightStereo's; and the step moved them."""
    model = case.port_model(**case.tiny)
    model.load_state_dict({k: v.float() if v.is_floating_point() else v
                           for k, v in got["model"].state_dict().items()})
    before = case.port_model(**case.tiny)
    before.load_state_dict(case.to_port(ref["variables"]))
    batch = torch_batch(ref["data"], torch.float32)
    out = {}
    for kernels in (True, False):
        for m in (model, before):
            set_kernels(m.eval(), kernels)
            with torch.inference_mode():
                out[kernels, m is model] = m(batch)["disp_pred"].clone()
    wired, eager = out[True, True], out[False, True]
    moved = (eager - out[False, False]).abs().max().item()
    print(f"after a step: kernel vs eager max-abs {(wired - eager).abs().max().item():.3g} px, "
          f"moved {moved:.3g} px")
    assert moved > 1e-3
    np.testing.assert_allclose(wired.numpy(), eager.numpy(), rtol=0, atol=atol)


def check_remat(case: Case, ref, plain: Optional[Dict] = None):
    """MODEL.REMAT: the same step with the hourglasses and regression heads
    (GwcNet, PSMNet) or the GRU iterations (the IGEV family) recomputed in
    the backward gives bit-equal gradients and running statistics, each
    BatchNorm updated as often as without it. `plain`: the step without it,
    if already taken (`steps`' port record: its model has since been
    stepped, but only its parameters)."""
    plain = plain or port_grads(case, ref, remat=False)
    rem = port_grads(case, ref, remat=True)
    assert rem["model"].remat and not plain["model"].remat
    assert rem["loss"] == plain["loss"]
    for k, g in plain["grads"].items():
        assert torch.equal(rem["grads"][k], g), k
    sa, sb = plain["model"].state_dict(), rem["model"].state_dict()
    for k, v in sa.items():
        if not k.endswith(("weight", "bias")):
            assert torch.equal(sb[k], v), k


def write_sceneflow_set(root: Path, n: int, hw, max_disp: int = 16):
    """`n` random-dot pairs in the SceneFlow layout (PNG views, PFM left
    disparities) and a split file listing them: its path."""
    from PIL import Image

    from openstereo_tpu_torch.data.readers import write_pfm
    from openstereo_tpu_torch.tools.overfit_check import make_stereogram

    for sub in ("left", "right"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    lines = []
    for i in range(n):
        left, right, disp = make_stereogram(np.random.RandomState(i), *hw, max_disp)
        for sub, img in (("left", left), ("right", right)):
            Image.fromarray(np.clip(np.round(img), 0, 255).astype(np.uint8)).save(
                root / sub / f"{i:04d}.png")
        write_pfm(str(root / "left" / f"{i:04d}.pfm"), disp)
        lines.append(f"left/{i:04d}.png right/{i:04d}.png left/{i:04d}.pfm")
    split = root / "split.txt"
    split.write_text("\n".join(lines))
    return split


def write_kitti_set(root: Path, n: int, hw, max_disp: int = 16):
    """`n` random-dot pairs in the KITTI 2015 layout (training/image_2 and
    image_3 PNG views, disp_occ_0 and, for RETURN_RIGHT_DISP, disp_occ_1
    uint16 PNG disparities × 256; the right one the left's, as no reader
    derives one from the other) and a split file listing them: its path."""
    from PIL import Image

    from openstereo_tpu_torch.tools.overfit_check import make_stereogram

    train = root / "training"
    for sub in ("image_2", "image_3", "disp_occ_0", "disp_occ_1"):
        (train / sub).mkdir(parents=True, exist_ok=True)
    lines = []
    for i in range(n):
        left, right, disp = make_stereogram(np.random.RandomState(i), *hw, max_disp)
        name = f"{i:06d}_10.png"
        for sub, img in (("image_2", left), ("image_3", right)):
            Image.fromarray(np.clip(np.round(img), 0, 255).astype(np.uint8)).save(
                train / sub / name)
        for sub in ("disp_occ_0", "disp_occ_1"):
            Image.fromarray(np.round(disp * 256.0).astype(np.uint16)).save(train / sub / name)
        lines.append(f"training/image_2/{name} training/image_3/{name} training/disp_occ_0/{name}")
    split = root / "split.txt"
    split.write_text("\n".join(lines))
    return split


def check_train_cli(case: Case, tmp_path: Path, monkeypatch, resume: bool = False,
                    cfg: Optional[str] = None, pad: Optional[Tuple[int, int]] = None):
    """`tools/train.py` on the model's config (or `cfg`) as it is but for the
    data paths, the model's size (`case.tiny`), the crop and the evaluation's
    pad or crop (`case.crop`, `pad` or `case.pad`: every transform's SIZE),
    the batch (2, for 2 steps over 4 random-dot pairs) and NUM_EPOCHS 1 (an
    evaluation and a checkpoint after it, whatever the config's intervals):
    2 steps with the config's optimizer, finite losses, the evaluation and a
    checkpoint; with `resume`, a resumed Trainer bit-equal to it. A KITTI
    config gets its pairs in the KITTI layout, every one of its data sets
    the same pairs (4 in all for training; a split the config leaves empty
    stays empty). A config that resumes from MODEL.CKPT (CFNet's part 2)
    starts afresh (`--ckpt -1`): the tiny run has no such checkpoint."""
    import json

    from openstereo_tpu_torch.config import load_config
    from openstereo_tpu_torch.runtime import Trainer
    from openstereo_tpu_torch.tools import train

    # JSONL metrics only: importing TensorBoard's writer takes seconds (tested
    # in `tests/test_torch_trainer.py`)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    d = yaml.safe_load((ROOT / cfg).read_text()) if cfg else case.config()
    pair_hw = (case.crop[0] + 8, case.crop[1] + 8)
    infos = d["DATA_CONFIG"]["DATA_INFOS"]
    if infos[0]["DATASET"] == "KittiDataset":
        split = write_kitti_set(tmp_path / "KITTI", 4 // len(infos), pair_hw)
    else:
        split = write_sceneflow_set(tmp_path / "SceneFlow", 4, pair_hw)
    for info in infos:
        info["DATA_PATH"] = str(split.parent)
        info["DATA_SPLIT"] = {k: str(split) if info["DATA_SPLIT"].get(k, "x") else ""
                              for k in ("TRAINING", "EVALUATING", "TESTING")}
    tf = d["DATA_CONFIG"]["DATA_TRANSFORM"]
    for mode, size in (("TRAINING", case.crop), ("EVALUATING", pad or case.pad)):
        for t in tf[mode]:
            if "SIZE" in t:
                t["SIZE"] = list(size)
    d["MODEL"].update({k.upper(): list(v) if isinstance(v, tuple) else v
                       for k, v in case.tiny.items()})
    d["OPTIMIZATION"].update(NUM_EPOCHS=1, BATCH_SIZE_PER_GPU=2)
    d.setdefault("TRAINER", {}).update(EVAL_INTERVAL=1, CKPT_SAVE_INTERVAL=1)
    d["EVALUATOR"]["BATCH_SIZE_PER_GPU"] = 2
    cfg_file = tmp_path / "cfg.yaml"
    cfg_file.write_text(yaml.safe_dump(d))
    fresh = ["--ckpt", "-1"] if "CKPT" in d["MODEL"] else []
    trainer = train.main(["--cfg_file", str(cfg_file), "--save_root", str(tmp_path / "runs"),
                          "--data_paths", str(tmp_path / "none.yaml"), "--device", "cpu",
                          "--workers", "1", *fresh])
    opt = d["OPTIMIZATION"]["OPTIMIZER"]["NAME"].lower()
    assert trainer.state.step == 2 and trainer.state.optimizer.name == opt
    assert trainer.model.dtype == (torch.bfloat16 if d["OPTIMIZATION"]["AMP"] else torch.float32)
    assert all(np.isfinite(v) for v in trainer.epoch_losses)
    evals = [r for r in map(json.loads, open(trainer.metrics_file)) if r["phase"] == "eval"]
    assert len(evals) == 1 and np.isfinite(evals[0]["epe"])
    assert trainer.saved_epochs() == [0]
    if resume:
        saved = torch.load(trainer.ckpt_path(0), weights_only=True)
        again = Trainer(load_config(str(cfg_file)), trainer.run_dir, device="cpu", num_workers=1)
        assert again.resume_ckpt() == 1 and again.state.step == 2
        for k, v in saved["model_state"].items():
            assert torch.equal(again.model.state_dict()[k], v), k
    print(f"{d['MODEL']['NAME']} via tools/train.py: losses {trainer.epoch_losses}, "
          f"evaluation EPE {evals[0]['epe']:.4f} px")
    # the checkpoint holds the config's full-width parts (FoundationStereo's ~0.7 GB): pytest
    # keeps its temporary directories, and a run cut by its time limit keeps them for days
    shutil.rmtree(trainer.ckpt_dir)


def check_overfit_recipe(case: Case, name: str, kwargs: Dict):
    """The overfit check's recipe for `name` runs 2 steps at the tiny size."""
    import json

    from openstereo_tpu_torch.tools import overfit_check

    res = overfit_check.main(["--model", name, "--steps", "2", "--batch", "1", "--size",
                              *map(str, case.crop), "--max_disp", str(case.tiny["max_disp"]),
                              "--device", "cpu", "--kwargs", json.dumps(kwargs)])
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))


def check_flax_fan_in(case: Case, pick: Callable) -> int:
    """`init_training_weights` on the model's config at full width draws the
    weights of the modules `pick(model)` lists with flax's law: a normal
    truncated at 2 σ whose variance is 1/fan_in, with flax's fan-in
    (`models.fan_in`). Over all their draws, scaled by sqrt(fan_in): std
    within 3 % of 1, mean within 0.02, none beyond 2/0.8796. Returns the
    number of modules."""
    from openstereo_tpu_torch.config import load_config
    from openstereo_tpu_torch.models import build_model, fan_in

    model = build_model(load_config(str(ROOT / case.cfg)).MODEL, device="cpu", seed=0,
                        init="train")
    picked = pick(model)
    x = torch.cat([m.weight.detach().flatten() * fan_in(m) ** 0.5 for m in picked]).double()
    print(f"{len(picked)} modules, {x.numel()} draws: std {float(x.std()):.4f}, "
          f"mean {float(x.mean()):.4f}")
    assert abs(float(x.std()) - 1) < 0.03 and abs(float(x.mean())) < 0.02
    assert float(x.abs().max()) <= 2.0 / 0.87962566103423978 + 1e-6
    return len(picked)
