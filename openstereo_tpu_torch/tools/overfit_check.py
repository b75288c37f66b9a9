"""Learning check: overfit one batch of random-dot stereograms (counterpart
of `tools/overfit_check.py`).

A random texture warped by a smooth disparity field gives pairs with exact
ground truth. LightStereo trains on one fixed batch in bf16 (AdamW, clip by
value 0.1, as the JAX tool) and the train EPE should fall below 3 px.
STTR, whose loss needs occlusion masks, gets the border occlusions of the
stereogram's disparity (as the JAX tool gives them) and trains in f32 with
its config's optimizer, RMSprop, at a constant rate with its clip by norm
35; the mean loss of the last 20 steps should fall below 0.8 of the first
5 steps' (the train EPE is printed beside it). GwcNet, PSMNet, CoExNet,
MSNet3D, MSNet2D, CFNet, CasGwcNet, CasPSMNet and FADNet, and IGEV, IGEVRT,
StereoBase (StereoBaseGRU), IGEVPP, FoundationStereo, FastFoundationStereo
and MonSter train the same way with their SceneFlow configs' dtype,
optimizer and clip (`RECIPES`; FADNet with Lamb; the GRU models in bf16
with AdamW, all TRAIN_ITERS GRU iterations unless `--kwargs` sets fewer)
at a constant rate, under the same check.

    python -m openstereo_tpu_torch.tools.overfit_check [--steps 400] [--device cpu]
    python -m openstereo_tpu_torch.tools.overfit_check --model STTR --steps 200 --batch 2 --lr 1e-4
    python -m openstereo_tpu_torch.tools.overfit_check --model GwcNet --steps 200 --batch 2 \
        --lr 1e-4
    python -m openstereo_tpu_torch.tools.overfit_check --model FADNet --steps 100 --batch 1 \
        --size 192 384 --lr 4e-3
    python -m openstereo_tpu_torch.tools.overfit_check --model IGEV --steps 60 --batch 2 \
        --lr 2e-4
    python -m openstereo_tpu_torch.tools.overfit_check --model FastFoundationStereo --steps 40 \
        --batch 1 --lr 2e-4
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def make_stereogram(rng: np.random.RandomState, h: int, w: int, max_disp: int):
    """Random texture + smooth disparity in [4, 0.75·max_disp] → (left, right,
    disp), images float32 [H,W,3] in [0,255] (`tools/overfit_check.py:22`)."""
    import cv2

    coarse = rng.rand(h // 32 + 2, w // 32 + 2).astype(np.float32)
    disp = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC)
    disp = 4.0 + (max_disp * 0.75 - 4.0) * (disp - disp.min()) / (np.ptp(disp) + 1e-6)
    texture = rng.rand(h, w + max_disp, 3).astype(np.float32)
    texture = cv2.GaussianBlur(texture, (5, 5), 1.5)
    left = texture[:, max_disp:]
    # right[y, x] = texture[y, x + max_disp - disp]
    xs = np.arange(w, dtype=np.float32)[None, :] + max_disp - disp
    right = np.stack([
        np.stack([np.interp(xs[y], np.arange(w + max_disp), texture[y, :, c])
                  for c in range(3)], axis=-1)
        for y in range(h)])
    return left * 255, right.astype(np.float32) * 255, disp


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="LightStereo")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--size", type=int, nargs=2, default=[192, 384])
    p.add_argument("--max_disp", type=int, default=64)
    p.add_argument("--lr", type=float, default=4e-4)
    p.add_argument("--cosine", action="store_true", help="cosine-decay the lr to 0 over --steps")
    p.add_argument("--kwargs", default="{}", help="extra model config keys as JSON")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def border_occlusions(disp: np.ndarray):
    """(left, right) occlusion masks of disparities [..., W]: a left pixel
    whose match x - d falls left of the frame, a right pixel whose match
    x + d falls right of it (the JAX tool's masks, `tools/overfit_check.py:79-87`)."""
    xs = np.arange(disp.shape[-1], dtype=np.float32)
    return xs - disp < 0, xs + disp >= disp.shape[-1]


# per model: compute dtype, optimizer and clip (its config's: `cfgs/<model>/*.yaml`), and
# the check on the run
LOSS_RULE = "mean loss of the last 20 steps < 0.8 x that of the first 5"
RECIPES = {"LightStereo": ("bf16", "adamw", ("value", 0.1), "final train EPE < 3 px"),
           "STTR": ("f32", "rmsprop", ("norm", 35.0), LOSS_RULE),
           "GwcNet": ("f32", "rmsprop", ("norm", 35.0), LOSS_RULE),
           "PSMNet": ("f32", "rmsprop", ("norm", 35.0), LOSS_RULE),
           "CoExNet": ("bf16", "rmsprop", ("value", 0.1), LOSS_RULE),
           "MSNet3D": ("f32", "adam", ("norm", 35.0), LOSS_RULE),
           "MSNet2D": ("f32", "adam", None, LOSS_RULE),
           "CFNet": ("f32", "rmsprop", None, LOSS_RULE),
           "CasGwcNet": ("f32", "rmsprop", None, LOSS_RULE),
           "CasPSMNet": ("f32", "rmsprop", None, LOSS_RULE),
           "FADNet": ("f32", "lamb", None, LOSS_RULE),
           "IGEV": ("bf16", "adamw", ("norm", 35.0), LOSS_RULE),
           "IGEVRT": ("bf16", "adamw", ("norm", 1.0), LOSS_RULE),
           "StereoBase": ("bf16", "adamw", ("value", 1.0), LOSS_RULE),
           "StereoBaseGRU": ("bf16", "adamw", ("value", 1.0), LOSS_RULE),
           "IGEVPP": ("bf16", "adamw", ("norm", 1.0), LOSS_RULE),
           "FoundationStereo": ("bf16", "adamw", ("norm", 1.0), LOSS_RULE),
           "FastFoundationStereo": ("bf16", "adamw", ("norm", 1.0), LOSS_RULE),
           "MonSter": ("bf16", "adamw", ("norm", 1.0), LOSS_RULE)}


def main(argv: Optional[Sequence[str]] = None):
    """Returns {'trajectory': [(step, loss, epe)], 'losses' (every step's),
    'components' (every step's loss terms by name), 'final_epe',
    'loss_ratio' (mean of the last 20 losses over the mean of the first 5),
    'converged'}."""
    args = parse_args(argv)
    if args.model not in RECIPES:
        raise NotImplementedError(f"{args.model}: no overfit recipe; the port trains "
                                  f"{sorted(RECIPES)}")
    import torch

    from ..config import Config
    from ..data.loader import batch_to_device
    from ..device import resolve_device
    from ..models import build_model
    from ..runtime.optim import Optimizer, constant_schedule, cosine_decay_schedule

    device = resolve_device(args.device)
    h, w = args.size
    rng = np.random.RandomState(0)
    samples = [make_stereogram(rng, h, w, args.max_disp) for _ in range(args.batch)]
    disp = np.stack([s[2] for s in samples]).astype(np.float32)
    arrays = {"left": np.stack([(s[0] / 255 - MEAN) / STD for s in samples]).astype(np.float32),
              "right": np.stack([(s[1] / 255 - MEAN) / STD for s in samples]).astype(np.float32),
              "disp": disp}
    dtype_name, opt_name, clip, rule = RECIPES[args.model]
    if args.model == "STTR":
        occ, occ_right = border_occlusions(disp)
        arrays.update(occ_mask=occ.astype(np.float32), occ_mask_right=occ_right.astype(np.float32))
    batch = batch_to_device(arrays, device)
    model_cfg = Config.from_dict({"NAME": args.model, "MAX_DISP": args.max_disp,
                                  **json.loads(args.kwargs)})
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype_name]
    model = build_model(model_cfg, dtype=dtype, device=device, seed=0, init="train")
    model.train()
    schedule = (cosine_decay_schedule(args.lr, args.steps) if args.cosine
                else constant_schedule(args.lr))
    # optax.adamw's default weight decay, 1e-4, as the JAX tool leaves it
    opt = Optimizer(model.named_parameters(), opt_name, schedule,
                    weight_decay=1e-4 if opt_name == "adamw" else 0.0, clip=clip)
    print(f"{args.model} {dtype_name}, {opt_name} lr {args.lr}, clip {clip}, batch "
          f"{args.batch} at {h}x{w}; check: {rule}", flush=True)
    trajectory, losses, components = [], [], []
    t0 = time.perf_counter()
    for i in range(args.steps):
        out = model(batch)
        loss, info = model.get_loss(out, batch)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        components.append({k: v.detach() for k, v in info.items()})
        if i % 25 == 0 or i == args.steps - 1:
            lv = float(loss.detach())
            epe = float((out["disp_pred"].detach() - batch["disp"]).abs().mean())
            trajectory.append((i, lv, epe))
            print(f"step {i:4d}  loss {lv:7.3f}  train-EPE {epe:6.2f} px"
                  + (f"  ({time.perf_counter() - t0:.0f}s)" if i else ""), flush=True)
    losses = [float(v) for v in losses]
    components = {k: [float(c[k]) for c in components] for k in components[0]}
    final = trajectory[-1][2]
    ratio = float(np.mean(losses[-20:]) / np.mean(losses[:5]))
    converged = final < 3.0 if args.model == "LightStereo" else ratio < 0.8
    print(f"final EPE {final:.2f} px, loss ratio (last 20 / first 5) {ratio:.4f} "
          f"({'CONVERGED' if converged else 'check hyperparameters'})")
    return {"trajectory": trajectory, "losses": losses, "components": components,
            "final_epe": final,
            "loss_ratio": ratio, "converged": converged}


if __name__ == "__main__":
    main()
