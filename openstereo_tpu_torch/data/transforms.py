"""EVALUATING transforms of the LightStereo configs, host-side numpy HWC.

The port's own copies of `openstereo_tpu/data/transforms.py:78-88`
(NormalizeImage) and `:298-323` (RightTopPad). Samples stay HWC float32
here, as in the JAX pipeline; the model's caller makes them NCHW tensors.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..config import Config

_IMG_KEYS = ("left", "right")
_MAP_KEYS = ("disp", "disp_right", "occ_mask", "occ_mask_right")


class Compose:
    def __init__(self, transforms: List):
        self.transforms = transforms

    def __call__(self, sample: Dict) -> Dict:
        for t in self.transforms:
            sample = t(sample)
        return sample


class NormalizeImage:
    def __init__(self, config):
        self.mean = np.asarray(config.MEAN, np.float32)
        self.std = np.asarray(config.STD, np.float32)

    def __call__(self, sample):
        for k in _IMG_KEYS:
            sample[k] = (sample[k] / 255.0 - self.mean) / self.std
        return sample


class RightTopPad:
    """Pad to a fixed eval shape: images edge-padded, maps zero-padded."""

    def __init__(self, config):
        self.size = tuple(config.SIZE)

    def __call__(self, sample):
        h, w = sample["left"].shape[:2]
        th, tw = self.size
        top, right = th - min(h, th), tw - min(w, tw)
        for k, v in list(sample.items()):
            if k in _IMG_KEYS:
                sample[k] = np.pad(v, [(top, 0), (0, right), (0, 0)], mode="edge")
            elif k in _MAP_KEYS:
                sample[k] = np.pad(v, [(top, 0), (0, right)], mode="constant")
        return sample


TRANSFORMS = {"NormalizeImage": NormalizeImage, "RightTopPad": RightTopPad}


def build_transforms(cfg_list) -> Compose:
    """[{NAME: ..., ...}, ...] → Compose. Names outside the ported set raise."""
    out = []
    for c in cfg_list:
        if c["NAME"] not in TRANSFORMS:
            raise NotImplementedError(
                f"transform {c['NAME']!r} is not ported yet (ported: "
                f"{sorted(TRANSFORMS)}; the training pipeline is ROADMAP Slice B)")
        out.append(TRANSFORMS[c["NAME"]](Config.from_dict(c)))
    return Compose(out)
