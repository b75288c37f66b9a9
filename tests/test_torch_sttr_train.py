"""STTR training in the port vs the JAX package's, on the CPU.

- One train step of a tiny STTR (2 layers, 2 heads of 8, 2 CAL blocks, 24×48
  crops, W' 16, batch 1, with occlusion masks) in f64 on both sides, the
  port with its K4 path (`rel_attention_trainable`: the plain forward and
  the analytic backward) and with its einsum path, against JAX's
  `value_and_grad` of the flax STTR (its einsum path, as on every non-TPU
  backend). Tolerances: each loss component rtol 1e-8; each parameter's
  gradient atol 1e-6·max|g| of its tensor (+1e-12 of the model's largest,
  for gradients that are zero in exact arithmetic); the parameters after
  one clipped RMSprop step atol 1e-9 (lr 1e-3: 1e-6 of a step). The
  reference's unused final LayerNorm (`transformer.norm`) gets no gradient.
  The JAX step is compiled once in this file.
- RMSprop with the STTR config's schedule (MultiStepLR on epochs, 100
  warm-up steps) and clip by norm 35 against the JAX package's
  `build_optimizer` (optax.rmsprop) over 5 steps; its state through a
  checkpoint.
- The FlyingThings3D-subset dataset and the loader bit-equal to JAX's
  (ZEROING_OCC off and on), and the STTR config run by the port's training
  CLI on a tiny set.
- The training initialiser: fixed values exact, drawn tensors with flax's
  laws (lecun-normal and he-normal, both truncated at 2 σ).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import jax
import jax.numpy as jnp
import optax

from openstereo_tpu.config import Config as JConfig
from openstereo_tpu.data.loader import StereoDataLoader as JaxLoader
from openstereo_tpu.models.sttr import sttr as js
from openstereo_tpu.runtime import optim as joptim
from openstereo_tpu.utils.torch_convert import convert_sttr

from openstereo_tpu_torch.config import Config, load_config
from openstereo_tpu_torch.data import readers
from openstereo_tpu_torch.data.loader import StereoDataLoader
from openstereo_tpu_torch.models import build_model, set_kernels
from openstereo_tpu_torch.models.sttr import STTR
from openstereo_tpu_torch.models.sttr.blocks import WNConv
from openstereo_tpu_torch.models.sttr.transformer import MultiheadAttentionRelative
from openstereo_tpu_torch.runtime import optim as toptim
from openstereo_tpu_torch.tools import train
from openstereo_tpu_torch.utils import jax_weights as jw

from test_torch_layers import run_jitted_fast
from test_torch_ops import to_nchw
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
CFG = yaml.safe_load((ROOT / "cfgs/sttr/sttr_flyingthings3d.yaml").read_text())
TINY = dict(channel_dim=16, nheads=2, num_attn_layers=2, cal_num_blocks=2, cal_feat_dim=8,
            cal_expansion_ratio=4)
H, W, TOTAL_STEPS = 24, 48, 640
LOSSES = ("loss", "loss_disp", "loss_rr", "loss_l1_raw", "loss_l1", "loss_occ_be")


def _batch():
    rng = np.random.RandomState(21)
    left = rng.randn(1, H, W, 3).astype(np.float32)
    disp = (rng.rand(1, H, W) * 14 + 1).astype(np.float32)
    disp[:, :2] = 0.0  # invalid rows
    return {"left": left, "right": np.roll(left, -5, axis=2) + 0.1 * rng.randn(1, H, W, 3),
            "disp": disp, "occ_mask": (rng.rand(1, H, W) > 0.8).astype(np.float32),
            "occ_mask_right": (rng.rand(1, H, W) > 0.8).astype(np.float32)}


def _variables(seed):
    """flax variables in the tree the JAX converter makes of the port's
    state_dict, drawn with numpy: kernels ~ N(0, 1/fan_in), LayerNorm scales
    and weight-norm gains 0.5..1.1, weight-norm directions ~ N(0, 1), the
    rest (biases, phi) ~ 0.1·N(0, 1)."""
    sd = {k: v.numpy() for k, v in STTR(**TINY).state_dict().items()}
    tree = convert_sttr(sd, num_attn_layers=TINY["num_attn_layers"],
                        cal_num_blocks=TINY["cal_num_blocks"])
    rng = np.random.RandomState(seed)

    def fill(path, a):
        name, shape = path[-1].key, np.shape(a)
        if name == "kernel":
            x = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("scale", "g"):
            x = rng.rand(*shape) * 0.6 + 0.5
        elif name == "v":
            x = rng.randn(*shape)
        else:
            x = rng.randn(*shape) * 0.1
        return np.asarray(x, np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _opt_cfg(max_norm):
    """The STTR config's OPTIMIZATION with the clip at `max_norm` and without
    the warm-up, whose lr at the first step is 0."""
    opt = yaml.safe_load(yaml.safe_dump(CFG["OPTIMIZATION"]))
    del opt["SCHEDULER"]["WARMUP"]
    opt["CLIP_GRAD"]["MAX_NORM"] = max_norm
    return opt


def _port_step(variables, kernels, max_norm=None):
    """(model, loss info, grads, optimizer) after one port step in f64."""
    model = STTR(**TINY, dtype=torch.float64).double()
    model.load_state_dict(jw.sttr_state_dict_from_jax(variables))
    set_kernels(model.train(), kernels)
    data = _batch()
    batch = {k: (to_nchw(v) if k in ("left", "right") else torch.from_numpy(v)).double()
             for k, v in data.items()}
    loss, info = model.get_loss(model(batch), batch)
    loss.backward()
    grads = {k: None if p.grad is None else p.grad.clone() for k, p in model.named_parameters()}
    opt = None
    if max_norm is not None:
        opt, _ = toptim.build_optimizer(Config.from_dict(_opt_cfg(max_norm)), TOTAL_STEPS,
                                        model.named_parameters())
        opt.step()
    return model, {"loss": float(loss), **{k: float(v) for k, v in info.items()}}, grads, opt


@pytest.fixture(scope="module")
def jax_step():
    """The JAX train step in f64 (forward, `get_loss`, gradients, the clipped
    RMSprop update of the JAX trainer's optax chain), compiled once. The clip
    sits at half the gradient's norm, so that it acts."""
    variables = _variables(22)
    _, _, grads, _ = _port_step(variables, False)
    norm = float(torch.sqrt(sum((g ** 2).sum() for g in grads.values() if g is not None)))
    max_norm = 0.5 * norm
    with jax.enable_x64(True):
        model = js.STTR(**TINY, dtype=jnp.float64)
        tx, _ = joptim.build_optimizer(JConfig.from_dict(_opt_cfg(max_norm)), TOTAL_STEPS)
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables["params"])
        jdata = {k: jnp.asarray(v, jnp.float64) for k, v in _batch().items()}

        def step(p, batch):
            def loss_fn(pp):
                return model.get_loss(model.apply({"params": pp}, batch, train=True), batch)

            (loss, info), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
            updates, _ = tx.update(g, tx.init(p), p)
            return loss, info, g, optax.apply_updates(p, updates)

        loss, info, g, after = jax.device_get(run_jitted_fast(step, params, jdata))
    return dict(variables=variables, max_norm=max_norm, norm=norm,
                info={"loss": float(loss), **{k: float(v) for k, v in info.items()}},
                grads=jw.sttr_state_dict_from_jax({"params": g}),
                after=jw.sttr_state_dict_from_jax({"params": after}))


@pytest.fixture(scope="module", params=[True, False], ids=["kernels", "eager"])
def port_step(request, jax_step):
    return _port_step(jax_step["variables"], request.param, jax_step["max_norm"])


def test_train_step_losses(jax_step, port_step):
    ref, got = jax_step["info"], port_step[1]
    assert set(got) == set(LOSSES) == set(ref)
    for k in LOSSES:
        print(f"{k}: port {got[k]!r}, JAX {ref[k]!r}")
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-8, err_msg=k)


def test_train_step_gradients(jax_step, port_step):
    ref, got = jax_step["grads"], port_step[2]
    assert set(got) == set(ref)
    scale = max(float(g.abs().max()) for k, g in ref.items() if not k.startswith("transformer.norm."))
    worst = 0.0
    for k, g in got.items():
        if k.startswith("transformer.norm."):  # built, never applied (as the reference)
            assert g is None, k
            continue
        r = ref[k].double().numpy()
        if np.abs(r).max() > 1e-9 * scale:
            worst = max(worst, np.abs(g.numpy() - r).max() / np.abs(r).max())
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-6 * np.abs(r).max() + 1e-12 * scale, err_msg=k)
    print(f"worst gradient error {worst:.3g} of its tensor's max|g|; global norm "
          f"{jax_step['norm']:.4g}, clip {jax_step['max_norm']:.4g}")


def test_train_step_updated_parameters(jax_step, port_step):
    model, _, _, opt = port_step
    assert opt.count == 1 and set(opt.state[next(iter(opt.state))]) == {"nu"}
    ref = jax_step["after"]
    for k, p in model.named_parameters():
        if k.startswith("transformer.norm."):
            continue
        np.testing.assert_allclose(p.detach().numpy(), ref[k].double().numpy(), rtol=0, atol=1e-9,
                                   err_msg=k)


def test_train_step_kernels_on_goes_through_the_trainable_k4(monkeypatch, jax_step):
    from openstereo_tpu_torch.models.sttr import transformer

    calls = []
    real = transformer.rel_attention_trainable
    monkeypatch.setattr(transformer, "rel_attention_trainable",
                        lambda *a: calls.append(a[6:]) or real(*a))
    _port_step(jax_step["variables"], True)
    # per layer: self (no mask, no raw), cross right-to-left, cross left-to-right
    assert calls == [(False, False)] * 5 + [(True, True)]


# --------------------------------------------------------------- RMSprop

def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"w": (rng.randn(4, 6) * 0.5).astype(np.float32),
            "b": (0.1 * rng.randn(5)).astype(np.float32)}


def test_rmsprop_with_the_sttr_schedule_and_clip_matches_optax(tmp_path):
    """5 steps from the STTR config (warm-up lr 0, then 1e-5·t; clip by norm
    35, acting at steps 1 and 3), the last 2 from a state restored through
    `state_dict`; schedule values past the warm-up and at the milestones."""
    d = CFG["OPTIMIZATION"]
    spe = 7
    tx, ref_sched = joptim.build_optimizer(JConfig.from_dict(d), d["NUM_EPOCHS"] * spe)
    params = {k: jnp.asarray(v) for k, v in _tree(1).items()}
    state = tx.init(params)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v)) for k, v in _tree(1).items()}
    opt, sched = toptim.build_optimizer(Config.from_dict(d), d["NUM_EPOCHS"] * spe, tparams.items())

    @jax.jit
    def update(g, state, params):
        updates, state = tx.update(g, state, params)
        return optax.apply_updates(params, updates), state

    for step in range(5):
        if step == 3:
            torch.save(opt.state_dict(), tmp_path / "opt.pth")
            opt, _ = toptim.build_optimizer(Config.from_dict(d), d["NUM_EPOCHS"] * spe,
                                            tparams.items())
            opt.load_state_dict(torch.load(tmp_path / "opt.pth", weights_only=True))
        g = {k: v * (40.0 if step in (1, 3) else 1.0) for k, v in _tree(10 + step).items()}
        params, state = update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k in g:
            np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(params[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=f"step {step} {k}")
        nu = state[1][0].nu  # chain(clip, rmsprop(scale_by_rms, ...))
        for k in g:
            np.testing.assert_allclose(opt.state[k]["nu"].numpy(), np.asarray(nu[k]),
                                       rtol=1e-5, atol=1e-12, err_msg=f"nu step {step} {k}")
    assert opt.count == 5
    for s in (0, 1, 50, 99, 100, 101, 10 * spe - 1, 10 * spe, 12 * spe, 16 * spe, 64 * spe):
        np.testing.assert_allclose(sched(s), float(ref_sched(jnp.asarray(s, jnp.int32))),
                                   rtol=2e-6, atol=1e-12, err_msg=f"lr at step {s}")


def test_rmsprop_is_not_torch_rmsprop():
    """optax's eps lies inside the root and its decay is 0.9: one step on
    g = 1e-4 moves a parameter by lr·g/sqrt(0.1·g² + 1e-8) = 0.953·lr, where
    torch's RMSprop at its defaults (α 0.99, eps outside the root) would move
    it by lr·g/(sqrt(0.01·g²) + 1e-8) = 9.99·lr; the port follows optax."""
    p = torch.nn.Parameter(torch.zeros(1, dtype=torch.float64))
    opt = toptim.Optimizer([("p", p)], "rmsprop", toptim.constant_schedule(1.0))
    p.grad = torch.full((1,), 1e-4, dtype=torch.float64)
    opt.step()
    np.testing.assert_allclose(-p.item(), 1e-4 / np.sqrt(0.1 * 1e-8 + 1e-8), rtol=1e-12)
    np.testing.assert_allclose(opt.state["p"]["nu"].item(), 1e-9, rtol=1e-12)


# --------------------------------------------------------------- data

def _write_things(root, n=3, hw=(40, 72)):
    """A tiny FlyingThings3D-subset layout: PNG views, PFM disparities
    (left and right, with NaNs and out-of-frame values), occlusion PNGs."""
    rng = np.random.RandomState(0)
    lines = []
    for i in range(n):
        paths = [f"{d}/{i:04d}.{ext}" for d, ext in (("left", "png"), ("right", "png"),
                                                      ("disp", "pfm"), ("disp_right", "pfm"),
                                                      ("occ", "png"), ("occ_right", "png"))]
        for p in paths:
            (root / p).parent.mkdir(exist_ok=True)
        for p in paths[:2]:
            Image.fromarray(rng.randint(0, 255, (*hw, 3), np.uint8)).save(root / p)
        for p in paths[2:4]:
            disp = (rng.rand(*hw) * 30 - 2).astype(np.float32)
            disp[rng.rand(*hw) > 0.95] = np.nan
            disp[0, :3] = hw[1] + 5
            readers.write_pfm(str(root / p), disp)
        for p in paths[4:]:
            Image.fromarray(((rng.rand(*hw) > 0.8) * 255).astype(np.uint8)).save(root / p)
        lines.append(" ".join(paths))
    (root / "split.txt").write_text("\n".join(lines))
    return str(root / "split.txt")


def _things_cfg(root, split, zeroing):
    d = yaml.safe_load(yaml.safe_dump(CFG["DATA_CONFIG"]))
    info = d["DATA_INFOS"][0]
    info.update(DATA_PATH=str(root), ZEROING_OCC=zeroing,
                DATA_SPLIT={"TRAINING": split, "EVALUATING": split, "TESTING": split})
    d["DATA_TRANSFORM"]["TRAINING"][0]["SIZE"] = [24, 48]
    d["DATA_TRANSFORM"]["EVALUATING"][0]["SIZE"] = [48, 80]
    return d


@pytest.mark.parametrize("zeroing", [False, True], ids=["ZEROING_OCC off", "ZEROING_OCC on"])
def test_flyingthings_loader_matches_jax(tmp_path, zeroing):
    """The STTR config's transforms (crop cut to 24×48, pad to 48×80), batch
    2 over 3 samples, training and evaluating: every key bit-equal."""
    d = _things_cfg(tmp_path, _write_things(tmp_path), zeroing)
    for mode in ("training", "evaluating"):
        ours = StereoDataLoader(Config.from_dict(d), 2, mode=mode, seed=4, num_workers=2)
        theirs = JaxLoader(JConfig.from_dict(d), 2, mode=mode, seed=4, num_workers=2)
        got, ref = list(ours.epoch(0)), list(theirs.epoch(0))
        assert len(got) == len(ref) == 2
        for g, r in zip(got, ref):
            assert g.keys() == r.keys()
            assert ("disp_right" in r) == (not zeroing) and "occ_mask_right" in r
            for k in r:
                if isinstance(r[k], list):
                    assert g[k] == r[k]
                else:
                    assert g[k].dtype == r[k].dtype and g[k].shape == r[k].shape, k
                    np.testing.assert_array_equal(g[k], r[k], err_msg=f"{mode} {k}")
        sample = ours.datasets[0].load(0)
        assert sample["occ_mask"].dtype == bool and not np.isnan(sample["disp"]).any()


def test_train_cli_runs_the_sttr_config_on_cpu(tmp_path, monkeypatch):
    """`tools/train.py` on the STTR config as it is but for the data paths,
    the model's width and depth (TINY), the crop (24×48) and the pad (48×80):
    one epoch of 2 steps with RMSprop, the evaluation (occlusion masks in the
    batch), a checkpoint, and a resumed Trainer bit-equal to it (RMSprop's
    nu included)."""
    from openstereo_tpu_torch.runtime import Trainer

    # JSONL metrics only: importing TensorBoard's writer takes seconds (tested
    # in `tests/test_torch_trainer.py`)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    d = yaml.safe_load(yaml.safe_dump(CFG))
    d["DATA_CONFIG"] = _things_cfg(tmp_path, _write_things(tmp_path, n=2), False)
    d["MODEL"].update({k.upper(): v for k, v in TINY.items()})
    d["OPTIMIZATION"]["NUM_EPOCHS"] = 1
    cfg_file = tmp_path / "sttr.yaml"
    cfg_file.write_text(yaml.safe_dump(d))
    trainer = train.main(["--cfg_file", str(cfg_file), "--save_root", str(tmp_path / "runs"),
                          "--data_paths", str(tmp_path / "none.yaml"), "--device", "cpu",
                          "--workers", "1"])
    assert trainer.state.step == 2 and trainer.state.optimizer.name == "rmsprop"
    assert all(np.isfinite(v) for v in trainer.epoch_losses)
    records = [json.loads(ln) for ln in open(trainer.metrics_file)]
    evals = [r for r in records if r["phase"] == "eval"]
    assert len(evals) == 1 and np.isfinite(evals[0]["epe"])
    saved = torch.load(trainer.ckpt_path(0), weights_only=True)
    again = Trainer(load_config(str(cfg_file)), trainer.run_dir, device="cpu", num_workers=1)
    assert again.resume_ckpt() == 1
    for k, v in saved["model_state"].items():
        assert torch.equal(again.model.state_dict()[k], v), k
    nu = again.state.optimizer.state_dict()["state"]
    assert any(float(st["nu"].abs().max()) > 0 for st in nu.values())
    for k, st in saved["optimizer_state"]["state"].items():
        assert torch.equal(nu[k]["nu"], st["nu"]), k


# --------------------------------------------------------------- initialiser

def test_sttr_training_initialiser():
    """Fixed values exact; each third of every packed attention projection
    lecun-normal over its fan-in (std 1/sqrt(128)), every weight-normed
    direction he-normal (std sqrt(2/fan_in)), both truncated at 2 σ as
    flax's: per tensor family, the std within 3 % and the mean within
    0.02 σ of flax's law (over 49k-790k draws), no draw beyond 2 σ."""
    cfg = load_config(str(ROOT / "cfgs/sttr/sttr_flyingthings3d.yaml"))
    model = build_model(cfg.MODEL, device="cpu", seed=0, init="train")
    assert float(model.regression_head.phi) == 0.0
    laws = {"q": [], "k": [], "v": [], "wn": []}
    wn_scale = []
    for m in model.modules():
        if isinstance(m, MultiheadAttentionRelative):
            assert torch.equal(m.in_proj_bias, torch.zeros_like(m.in_proj_bias))
            for name, third in zip("qkv", m.in_proj_weight.detach().chunk(3)):
                laws[name].append(third.flatten() * m.embed_dim ** 0.5)
        elif isinstance(m, WNConv):
            assert torch.equal(m.weight_g, torch.ones_like(m.weight_g))
            assert torch.equal(m.bias, torch.zeros_like(m.bias))
            fan = m.weight_v[0].numel()
            laws["wn"].append(m.weight_v.detach().flatten() * (fan / 2.0) ** 0.5)
            wn_scale.append(fan)
        elif isinstance(m, torch.nn.LayerNorm):
            assert torch.equal(m.weight, torch.ones_like(m.weight))
            assert torch.equal(m.bias, torch.zeros_like(m.bias))
    ref = np.asarray(jax.nn.initializers.lecun_normal()(jax.random.key(0), (400, 500)))
    ref_std = float(ref.std() * np.sqrt(400))  # flax's law, scaled to unit variance: ~1
    for name, xs in laws.items():
        x = torch.cat(xs).double()
        std, mean = float(x.std()), float(x.mean())
        print(f"{name}: {x.numel()} draws, std {std:.4f} (flax {ref_std:.4f}), mean {mean:.4f}")
        assert abs(std / ref_std - 1) < 0.03 and abs(mean) < 0.02, name
        assert float(x.abs().max()) <= 2.0 / 0.87962566103423978 + 1e-6, name
