"""Learning check: overfit one batch of random-dot stereograms (counterpart
of `tools/overfit_check.py`).

A random texture warped by a smooth disparity field gives pairs with exact
ground truth; the model trains on one fixed batch in bf16 (AdamW, clip by
value 0.1, as the JAX tool) and the train EPE should fall below 3 px.

    python -m openstereo_tpu_torch.tools.overfit_check [--steps 400] [--device cpu]

LightStereo only for now.
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


def main(argv: Optional[Sequence[str]] = None):
    """Returns {'trajectory': [(step, loss, epe)], 'final_epe', 'converged'}."""
    args = parse_args(argv)
    if args.model != "LightStereo":
        raise NotImplementedError(f"{args.model}: the port trains LightStereo only "
                                  "(ROADMAP item 8)")
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
    batch = batch_to_device({
        "left": np.stack([(s[0] / 255 - MEAN) / STD for s in samples]).astype(np.float32),
        "right": np.stack([(s[1] / 255 - MEAN) / STD for s in samples]).astype(np.float32),
        "disp": np.stack([s[2] for s in samples]).astype(np.float32),
    }, device)
    model_cfg = Config.from_dict({"NAME": args.model, "MAX_DISP": args.max_disp,
                                  **json.loads(args.kwargs)})
    model = build_model(model_cfg, dtype=torch.bfloat16, device=device, seed=0, init="train")
    model.train()
    schedule = (cosine_decay_schedule(args.lr, args.steps) if args.cosine
                else constant_schedule(args.lr))
    # optax.adamw's default weight decay, 1e-4, as the JAX tool leaves it
    opt = Optimizer(model.named_parameters(), "adamw", schedule, weight_decay=1e-4,
                    clip=("value", 0.1))
    trajectory = []
    t0 = time.perf_counter()
    for i in range(args.steps):
        out = model(batch)
        loss, _ = model.get_loss(out, batch)
        opt.zero_grad()
        loss.backward()
        opt.step()
        if i % 25 == 0 or i == args.steps - 1:
            lv = float(loss.detach())
            epe = float((out["disp_pred"].detach() - batch["disp"]).abs().mean())
            trajectory.append((i, lv, epe))
            print(f"step {i:4d}  loss {lv:7.3f}  train-EPE {epe:6.2f} px"
                  + (f"  ({time.perf_counter() - t0:.0f}s)" if i else ""), flush=True)
    final = trajectory[-1][2]
    print(f"final EPE {final:.2f} px ({'CONVERGED' if final < 3.0 else 'check hyperparameters'})")
    return {"trajectory": trajectory, "final_epe": final, "converged": final < 3.0}


if __name__ == "__main__":
    main()
