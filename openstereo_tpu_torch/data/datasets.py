"""Split-file stereo datasets: the port's copy of
`openstereo_tpu/data/datasets.py:31-103` (`DatasetTemplate`,
`SceneFlowDataset`).

A dataset reads a space-separated split file of root-relative paths and
yields numpy samples {'left' [H,W,3], 'right' [H,W,3], 'disp' [H,W],
['disp_right'], 'valid', 'index', 'name'}, transformed on the host with the
sample's numpy Generator. The JAX package's other dataset classes are
ROADMAP item 8.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..config import Config
from ..registry import DATASETS
from . import readers
from .transforms import build_transforms


class DatasetTemplate:
    """`datasets.py:31`."""

    def __init__(self, data_info: Config, data_cfg: Config, mode: str):
        self.data_info = data_info
        self.data_cfg = data_cfg
        self.mode = mode
        self.root = data_info.DATA_PATH
        split_file = data_info.DATA_SPLIT[mode.upper()]
        self.data_list: List[List[str]] = []
        if os.path.exists(split_file):
            with open(split_file) as fp:
                self.data_list = [ln.strip().split(" ") for ln in fp if ln.strip()]
        self.transform = build_transforms(data_cfg.DATA_TRANSFORM[mode.upper()])
        if data_info.get("RETURN_SUPER_PIXEL", False):
            raise NotImplementedError(
                "RETURN_SUPER_PIXEL (NMRF's superpixel labels) is ROADMAP item 18")

    def __len__(self) -> int:
        return len(self.data_list)

    def _paths(self, idx: int, n: Optional[int] = None) -> List[str]:
        item = self.data_list[idx]
        return [os.path.join(self.root, p) for p in (item[:n] if n else item)]

    def _finish(self, sample: Dict, idx: int, name: str,
                rng: Optional[np.random.Generator] = None) -> Dict:
        """Transform with `rng`, then add 'valid' (disp < 512), 'index' and
        'name' (`datasets.py:80-92`)."""
        sample["_rng"] = rng
        sample = self.transform(sample)
        sample.pop("_rng", None)
        if "disp" in sample:
            sample["valid"] = sample["disp"] < 512
        sample["index"] = idx
        sample["name"] = name
        return sample

    def load(self, idx: int, rng: Optional[np.random.Generator] = None) -> Dict:
        raise NotImplementedError


@DATASETS.register
class SceneFlowDataset(DatasetTemplate):
    """PNG views and PFM disparities (`datasets.py:98`)."""

    def load(self, idx, rng=None):
        left_p, right_p, disp_p = self._paths(idx, 3)
        sample = {
            "left": readers.read_image_rgb(left_p),
            "right": readers.read_image_rgb(right_p),
            "disp": readers.read_disp_pfm(disp_p),
        }
        if np.isnan(sample["disp"]).any():
            raise ValueError(f"NaN disparity in {disp_p}")
        if self.data_info.get("RETURN_RIGHT_DISP", False):
            sample["disp_right"] = readers.read_disp_pfm(disp_p.replace("left", "right"))
        return self._finish(sample, idx, left_p, rng)
