"""Single image-pair inference CLI (counterpart of `tools/infer.py`).

    python -m openstereo_tpu_torch.tools.infer --cfg_file cfgs/lightstereo/lightstereo_s_sceneflow.yaml \\
        --left_img_path left.png --right_img_path right.png [--pretrained x.pth] \\
        [--device cpu] [--out disp_pred.png]

Builds the config's EVALUATING transforms, runs the model in bf16 (random
weights from seed 0, as the JAX CLI's key 0, unless --pretrained names a
reference OpenStereo .pth),
and writes the disparity as a 16-bit PNG scaled by 256, as the JAX CLI does.
Runs on the CUDA card unless --device cpu is given.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..config import load_config
from ..data.readers import read_image_rgb
from ..data.transforms import build_transforms
from ..device import resolve_device
from ..models import build_model
from ..runtime.pretrained import load_state_dict_file


def load_pretrained(model: torch.nn.Module, path: str) -> int:
    """Load a reference OpenStereo checkpoint ({'model_state': sd} or a bare
    state_dict); the port's keys are the reference's, so no conversion."""
    state = load_state_dict_file(path)
    model.load_state_dict(state)
    return len(state)


def run_pair(model: torch.nn.Module, transforms, left: np.ndarray,
             right: np.ndarray) -> np.ndarray:
    """HWC RGB float32 images in [0,255] → disparity [H,W] float32 (numpy),
    at the transformed (padded) size."""
    sample: Dict[str, np.ndarray] = transforms({"left": left, "right": right})
    device = next(model.parameters()).device
    batch = {k: torch.from_numpy(np.ascontiguousarray(sample[k].transpose(2, 0, 1)))[None]
             .to(device) for k in ("left", "right")}
    with torch.inference_mode():
        disp = model(batch)["disp_pred"][0]
    return disp.float().cpu().numpy()


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cfg_file", required=True)
    p.add_argument("--left_img_path", required=True)
    p.add_argument("--right_img_path", required=True)
    p.add_argument("--pretrained", default=None, help="reference OpenStereo .pth weights")
    p.add_argument("--out", default="disp_pred.png")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from PIL import Image

    device = resolve_device(args.device)
    cfg = load_config(args.cfg_file)
    model = build_model(cfg.MODEL, dtype=torch.bfloat16, device=device, seed=0)
    if args.pretrained:
        print(f"loaded {load_pretrained(model, args.pretrained)} tensors from {args.pretrained}")
    tf = build_transforms(cfg.DATA_CONFIG.DATA_TRANSFORM["EVALUATING"])
    disp = run_pair(model, tf, read_image_rgb(args.left_img_path),
                    read_image_rgb(args.right_img_path))
    Image.fromarray((disp * 256.0).astype(np.uint16)).save(args.out)
    print(f"wrote {args.out}  (disp range {disp.min():.2f}..{disp.max():.2f})")
    return disp


if __name__ == "__main__":
    main()
