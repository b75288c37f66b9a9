"""Image reader: the port's copy of `openstereo_tpu/data/readers.py:20`."""

from __future__ import annotations

import numpy as np


def read_image_rgb(path: str) -> np.ndarray:
    """RGB image as float32 [H,W,3] in [0,255] (HWC, as the JAX reader)."""
    from PIL import Image

    return np.array(Image.open(path).convert("RGB"), dtype=np.float32)
