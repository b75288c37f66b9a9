"""Split-file stereo datasets: the port's copy of
`openstereo_tpu/data/datasets.py:31-147` (`DatasetTemplate`,
`SceneFlowDataset`, `FlyingThings3DSubsetDataset`) and `:150-216`, the
evaluation sets (`KittiDataset`, `DrivingDataset`, `MiddleburyDataset`,
`ETH3DDataset`).

A dataset reads a space-separated split file of root-relative paths and
yields numpy samples {'left' [H,W,3], 'right' [H,W,3], 'disp' [H,W],
['disp_right'], ['occ_mask', 'occ_mask_right'], 'valid', 'index', 'name'},
transformed on the host with the sample's numpy Generator. The JAX
package's other dataset classes are ROADMAP item 8d.
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


def _left_border_occ(disp: np.ndarray) -> np.ndarray:
    """Pixels whose match falls left of the frame (`datasets.py:105-108`)."""
    w = disp.shape[-1]
    return (np.arange(w, dtype=np.float32)[None, :] - disp) < 0


def _right_border_occ(disp_right: np.ndarray) -> np.ndarray:
    """Right-view pixels whose match falls right of the frame (`datasets.py:111-113`)."""
    w = disp_right.shape[-1]
    return (np.arange(w, dtype=np.float32)[None, :] + disp_right) > w


@DATASETS.register
class FlyingThings3DSubsetDataset(DatasetTemplate):
    """STTR's FlyingThings3D subset (`datasets.py:116-147`): six paths a line
    (left, right, disp, disp_right, occ, occ_right); NaN disparities become
    0. RETURN_OCC_MASK reads the occlusion PNGs as bool; ZEROING_OCC zeroes
    the disparity outside the frame and at the (border-extended) occlusions
    and drops disp_right."""

    def load(self, idx, rng=None):
        from PIL import Image

        left_p, right_p, disp_p, disp_r_p, occ_p, occ_r_p = self._paths(idx, 6)
        sample = {
            "left": readers.read_image_rgb(left_p),
            "right": readers.read_image_rgb(right_p),
            "disp": np.nan_to_num(readers.read_disp_pfm(disp_p), nan=0.0),
            "disp_right": np.nan_to_num(readers.read_disp_pfm(disp_r_p), nan=0.0),
        }
        if self.data_info.get("RETURN_OCC_MASK", False):
            sample["occ_mask"] = np.array(Image.open(occ_p)).astype(bool)
            sample["occ_mask_right"] = np.array(Image.open(occ_r_p)).astype(bool)
        if self.data_info.get("ZEROING_OCC", False):
            sample = self._zero_occ(sample)
        return self._finish(sample, idx, left_p, rng)

    @staticmethod
    def _zero_occ(sample: Dict) -> Dict:
        disp = sample["disp"]
        w = disp.shape[-1]
        disp[(disp > w) | (disp < 0)] = 0
        sample["occ_mask"] |= _left_border_occ(disp)
        if "disp_right" in sample:
            sample["occ_mask_right"] |= _right_border_occ(sample["disp_right"])
        sample.pop("disp_right", None)
        disp[sample["occ_mask"]] = 0
        sample["disp"] = np.ascontiguousarray(disp, np.float32)
        return sample


@DATASETS.register
class KittiDataset(DatasetTemplate):
    """KITTI 2012/2015 (`datasets.py:150`): uint16 PNG disparities / 256, 0
    invalid. USE_NOC reads `disp_noc` in place of `disp_occ`;
    RETURN_RIGHT_DISP also reads the right view's (`c_0` → `c_1` in the
    path)."""

    def load(self, idx, rng=None):
        left_p, right_p, disp_p = self._paths(idx, 3)
        if self.data_info.get("USE_NOC", False):
            disp_p = disp_p.replace("disp_occ", "disp_noc")
        sample = {
            "left": readers.read_image_rgb(left_p),
            "right": readers.read_image_rgb(right_p),
            "disp": readers.read_disp_png_scaled(disp_p, 256.0),
        }
        if self.data_info.get("RETURN_RIGHT_DISP", False):
            sample["disp_right"] = readers.read_disp_png_scaled(disp_p.replace("c_0", "c_1"), 256.0)
        return self._finish(sample, idx, left_p, rng)


@DATASETS.register
class DrivingDataset(DatasetTemplate):
    """DrivingStereo (`datasets.py:169`): KITTI-format PNG disparities / 256."""

    def load(self, idx, rng=None):
        left_p, right_p, disp_p = self._paths(idx, 3)
        sample = {
            "left": readers.read_image_rgb(left_p),
            "right": readers.read_image_rgb(right_p),
            "disp": readers.read_disp_png_scaled(disp_p, 256.0),
        }
        return self._finish(sample, idx, left_p, rng)


class _PfmWithNoccMask(DatasetTemplate):
    """A PFM disparity (inf → 0) and a non-occlusion mask PNG, read as
    grayscale: every pixel that is not 255 is occluded (`datasets.py:182`).
    The mask's path is the left image's (`mask_from_left`) or the
    disparity's, with `mask_subst` replaced."""

    mask_from_left = True
    mask_subst = ("", "")

    def load(self, idx, rng=None):
        from PIL import Image

        left_p, right_p, disp_p = self._paths(idx, 3)
        disp = readers.read_disp_pfm(disp_p)
        disp[np.isinf(disp)] = 0
        mask_p = (left_p if self.mask_from_left else disp_p).replace(*self.mask_subst)
        occ = np.array(Image.open(mask_p).convert("L"), np.float32) != 255.0
        sample = {
            "left": readers.read_image_rgb(left_p),
            "right": readers.read_image_rgb(right_p),
            "disp": disp,
            "occ_mask": occ,
        }
        return self._finish(sample, idx, left_p, rng)


@DATASETS.register
class MiddleburyDataset(_PfmWithNoccMask):
    """Middlebury (`datasets.py:203`): the mask beside the left image
    (`im0.png` → `mask0nocc.png`)."""

    mask_from_left = True
    mask_subst = ("im0.png", "mask0nocc.png")


@DATASETS.register
class ETH3DDataset(_PfmWithNoccMask):
    """ETH3D (`datasets.py:211`): the mask beside the disparity
    (`disp0GT.pfm` → `mask0nocc.png`)."""

    mask_from_left = False
    mask_subst = ("disp0GT.pfm", "mask0nocc.png")
