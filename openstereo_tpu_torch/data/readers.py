"""Image and disparity readers: the port's copies of
`openstereo_tpu/data/readers.py:20` (`read_image_rgb`), `:35-67`
(`read_pfm`, `read_disp_pfm`) and `:69` (`read_disp_png_scaled`)."""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np


def read_image_rgb(path: str) -> np.ndarray:
    """RGB image as float32 [H,W,3] in [0,255] (HWC, as the JAX reader;
    PNG decodes losslessly, so PIL gives the JAX reader's cv2 pixels)."""
    from PIL import Image

    return np.array(Image.open(path).convert("RGB"), dtype=np.float32)


def read_pfm(path: str) -> Tuple[np.ndarray, float]:
    """Portable FloatMap → (data [H,W] or [H,W,3], scale).

    'Pf'/'PF' header, a dims line (comments skipped), a scale line whose sign
    gives the byte order, rows stored bottom to top.
    """
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header not in (b"PF", b"Pf"):
            raise ValueError(f"not a PFM file: {path}")
        dims = f.readline()
        while dims.startswith(b"#"):
            dims = f.readline()
        m = re.match(rb"^(\d+)\s+(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"malformed PFM header in {path}")
        width, height = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().rstrip())
        data = np.fromfile(f, ("<" if scale < 0 else ">") + "f")
    shape = (height, width, 3) if header == b"PF" else (height, width)
    return np.flipud(data.reshape(shape)).copy(), abs(scale)


def read_disp_pfm(path: str) -> np.ndarray:
    return read_pfm(path)[0].astype(np.float32)


def read_disp_png_scaled(path: str, divisor: float = 256.0) -> np.ndarray:
    """A uint16 PNG disparity / divisor as float32; 0 marks an invalid pixel
    (the KITTI convention)."""
    from PIL import Image

    return np.array(Image.open(path), dtype=np.float32) / divisor


def write_pfm(path: str, data: np.ndarray, scale: float = 1.0) -> None:
    """Little-endian PFM writer, the inverse of `read_pfm` ([H,W] or [H,W,3])."""
    data = np.asarray(data, np.float32)
    header = b"PF" if data.ndim == 3 else b"Pf"
    with open(path, "wb") as f:
        f.write(header + b"\n%d %d\n%r\n" % (data.shape[1], data.shape[0], -abs(scale)))
        np.flipud(data).astype("<f4").tofile(f)
