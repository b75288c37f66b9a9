"""Stereo data augmentation, host-side numpy HWC float32: the port's copy of
`openstereo_tpu/data/transforms.py` (whole file).

Config names (NAME/SIZE/PROB/...) are the JAX package's, so its YAML
pipelines load unchanged. Every random transform draws from the numpy
`Generator` the loader puts in the sample under '_rng', in the JAX
transform's order, so a sample and its generator give the JAX pipeline's
bytes. Samples stay HWC here; the loader's batch adapter makes NCHW
tensors. cv2 is imported by the transforms that use it, when they run.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..config import Config
from ..registry import TRANSFORMS

_IMG_KEYS = ("left", "right")
_MAP_KEYS = ("disp", "disp_right", "occ_mask", "occ_mask_right")


def _rng(sample: Dict) -> np.random.Generator:
    return sample.get("_rng") or np.random.default_rng()


class Compose:
    def __init__(self, transforms: List):
        self.transforms = transforms

    def __call__(self, sample: Dict) -> Dict:
        for t in self.transforms:
            sample = t(sample)
        return sample


def build_transforms(cfg_list) -> Compose:
    """[{NAME: ..., ...}, ...] → Compose (`transforms.py:45`)."""
    return Compose([TRANSFORMS.get(c["NAME"])(config=Config.from_dict(c)) for c in cfg_list])


@TRANSFORMS.register
class TransposeImage:
    """No-op: samples stay HWC until the batch adapter (`transforms.py:51`)."""

    def __init__(self, config=None):
        pass

    def __call__(self, sample):
        return sample


@TRANSFORMS.register
class ToTensor:
    """float32 cast only (`transforms.py:62`); tensors are made per batch."""

    def __init__(self, config=None):
        pass

    def __call__(self, sample):
        for k, v in sample.items():
            if k == "super_pixel_label":
                continue
            if isinstance(v, np.ndarray) and v.dtype != np.float32:
                sample[k] = v.astype(np.float32)
        return sample


@TRANSFORMS.register
class NormalizeImage:
    def __init__(self, config):
        self.mean = np.asarray(config.MEAN, np.float32)
        self.std = np.asarray(config.STD, np.float32)

    def __call__(self, sample):
        for k in _IMG_KEYS:
            sample[k] = (sample[k] / 255.0 - self.mean) / self.std
        return sample


@TRANSFORMS.register
class RandomCrop:
    """Random crop, optionally with ±2 px vertical jitter of the right view
    (`transforms.py:90`). The loader may set `crop_size` per batch."""

    def __init__(self, config):
        self.crop_size = tuple(config.SIZE)
        self.base_size = tuple(config.SIZE)
        self.y_jitter = bool(config.get("Y_JITTER", False))

    def __call__(self, sample):
        rng = _rng(sample)
        ch, cw = self.crop_size
        h, w = sample["left"].shape[:2]
        if cw > w or ch > h:
            return sample
        n = 2 if (self.y_jitter and rng.random() < 0.5) else 0
        y1 = int(rng.integers(n, h - ch - n + 1))
        x1 = int(rng.integers(0, w - cw + 1))
        y2 = y1 + int(rng.integers(-n, n + 1))
        for k, v in list(sample.items()):
            if not isinstance(v, np.ndarray) or v.ndim < 2:
                continue
            y = y2 if k == "right" else y1
            sample[k] = v[y: y + ch, x1: x1 + cw]
        return sample


@TRANSFORMS.register
class RandomScale:
    """Random iso/anisotropic rescale; disparities scale with x (`transforms.py:118`)."""

    def __init__(self, config):
        self.crop_size = tuple(config.SIZE)
        self.min_scale = config.MIN_SCALE
        self.max_scale = config.MAX_SCALE
        self.scale_prob = config.SCALE_PROB
        self.stretch_prob = config.STRETCH_PROB
        self.max_stretch = 0.2

    def __call__(self, sample):
        import cv2

        rng = _rng(sample)
        h, w = sample["left"].shape[:2]
        min_scale = max((self.crop_size[0] + 8) / h, (self.crop_size[1] + 8) / w)
        scale = 2.0 ** rng.uniform(self.min_scale, self.max_scale)
        sx = sy = scale
        if rng.random() < self.stretch_prob:
            sx *= 2.0 ** rng.uniform(-self.max_stretch, self.max_stretch)
            sy *= 2.0 ** rng.uniform(-self.max_stretch, self.max_stretch)
        sx, sy = max(sx, min_scale), max(sy, min_scale)
        if rng.random() < self.scale_prob:
            for k in _IMG_KEYS:
                sample[k] = cv2.resize(sample[k], None, fx=sx, fy=sy,
                                       interpolation=cv2.INTER_LINEAR)
            for k in ("disp", "disp_right"):
                if k in sample:
                    d = cv2.resize(sample[k], None, fx=sx, fy=sy, interpolation=cv2.INTER_LINEAR)
                    sample[k] = d * sx
        return sample


def sparse_disp_resize(disp: np.ndarray, fx: float, fy: float) -> np.ndarray:
    """Nearest scatter of the valid (> 0) disparities (`transforms.py:152`)."""
    h, w = disp.shape[:2]
    h1, w1 = int(round(h * fy)), int(round(w * fx))
    ys, xs = np.nonzero(disp > 0)
    vals = disp[ys, xs] * fx
    xx = np.round(xs * fx).astype(np.int32)
    yy = np.round(ys * fy).astype(np.int32)
    keep = (xx > 0) & (xx < w1) & (yy > 0) & (yy < h1)
    out = np.zeros((h1, w1), np.float32)
    out[yy[keep], xx[keep]] = vals[keep]
    return out


@TRANSFORMS.register
class RandomSparseScale:
    """Rescale that keeps sparse ground truth sparse (`transforms.py:167`)."""

    def __init__(self, config):
        self.crop_size = tuple(config.SIZE)
        self.min_scale = config.MIN_SCALE
        self.max_scale = config.MAX_SCALE
        self.scale_prob = config.SCALE_PROB

    def __call__(self, sample):
        import cv2

        rng = _rng(sample)
        h, w = sample["left"].shape[:2]
        min_scale = max((self.crop_size[0] + 1) / h, (self.crop_size[1] + 1) / w)
        scale = max(2.0 ** rng.uniform(self.min_scale, self.max_scale), min_scale)
        if rng.random() < self.scale_prob:
            for k in _IMG_KEYS:
                sample[k] = cv2.resize(sample[k], None, fx=scale, fy=scale,
                                       interpolation=cv2.INTER_LINEAR)
            for k in ("disp", "disp_right"):
                if k in sample:
                    sample[k] = sparse_disp_resize(sample[k], scale, scale)
        return sample


@TRANSFORMS.register
class RandomErase:
    """Erase random rectangles of the right view with its mean colour
    (`transforms.py:192`)."""

    def __init__(self, config):
        self.prob = config.PROB
        self.max_time = config.MAX_TIME
        self.bounds = config.BOUNDS

    def __call__(self, sample):
        rng = _rng(sample)
        img2 = sample["right"]
        h, w = img2.shape[:2]
        if rng.random() < self.prob:
            mean_color = img2.reshape(-1, 3).mean(0)
            for _ in range(int(rng.integers(1, self.max_time + 1))):
                x0 = int(rng.integers(0, w))
                y0 = int(rng.integers(0, h))
                dx = int(rng.integers(self.bounds[0], self.bounds[1]))
                dy = int(rng.integers(self.bounds[0], self.bounds[1]))
                img2[y0: y0 + dy, x0: x0 + dx] = mean_color
        sample["right"] = img2
        if "super_pixel_label" in sample:
            sample["occ_mask_2"] = np.zeros((h, w), dtype=bool)
        return sample


def _adjust_brightness(img, f):
    img *= np.float32(f)
    return img


def _adjust_contrast(img, f):
    import cv2

    mean = float(cv2.cvtColor(img, cv2.COLOR_RGB2GRAY).mean())
    img *= np.float32(f)
    img += np.float32(mean * (1 - f))
    return img


def _adjust_saturation(img, f):
    import cv2

    gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)[..., None]
    img *= np.float32(f)
    img += gray * np.float32(1 - f)
    return img


def _adjust_hue(img, hue_shift):
    import cv2

    hsv = cv2.cvtColor(np.clip(img, 0, 255).astype(np.uint8), cv2.COLOR_RGB2HSV)
    hsv[..., 0] = (hsv[..., 0].astype(np.int32) + int(hue_shift * 180)) % 180
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB).astype(np.float32)


@TRANSFORMS.register
class StereoColorJitter:
    """Brightness/contrast/saturation/hue jitter, the same for both views or,
    with probability ASYMMETRIC_PROB, drawn per view (`transforms.py:252`)."""

    def __init__(self, config):
        self.brightness = self._range(config.BRIGHTNESS)
        self.contrast = self._range(config.CONTRAST)
        self.saturation = self._range(config.SATURATION)
        hue = config.HUE / 3.14  # the reference divides by pi
        self.hue = (-hue, hue) if np.isscalar(hue) else tuple(hue)
        self.asymmetric_prob = config.ASYMMETRIC_PROB

    @staticmethod
    def _range(v):
        if isinstance(v, (list, tuple)):
            return tuple(v)
        return (max(0.0, 1.0 - v), 1.0 + v)

    def _jitter(self, img, rng: np.random.Generator):
        ops = [
            lambda im: _adjust_brightness(im, rng.uniform(*self.brightness)),
            lambda im: _adjust_contrast(im, rng.uniform(*self.contrast)),
            lambda im: _adjust_saturation(im, rng.uniform(*self.saturation)),
            lambda im: _adjust_hue(im, rng.uniform(*self.hue)),
        ]
        for i in rng.permutation(4):
            img = ops[i](img)
        img = np.asarray(img, np.float32)
        np.clip(img, 0, 255, out=img)
        return img

    def __call__(self, sample):
        rng = _rng(sample)
        if rng.random() < self.asymmetric_prob:
            sample["left"] = self._jitter(sample["left"], rng)
            sample["right"] = self._jitter(sample["right"], rng)
        else:
            stack = np.concatenate([sample["left"], sample["right"]], axis=0)
            stack = self._jitter(stack, rng)
            sample["left"], sample["right"] = np.split(stack, 2, axis=0)
        return sample


def _pad_sample(sample, pad_top, pad_right, pad_bottom, pad_left):
    for k, v in list(sample.items()):
        if k in _IMG_KEYS:
            sample[k] = np.pad(v, [(pad_top, pad_bottom), (pad_left, pad_right), (0, 0)],
                               mode="edge")
        elif k in _MAP_KEYS:
            sample[k] = np.pad(v, [(pad_top, pad_bottom), (pad_left, pad_right)],
                               mode="constant")
    return sample


@TRANSFORMS.register
class RightTopPad:
    """Pad to a fixed eval shape: images edge-padded, maps zero-padded
    (`transforms.py:310`)."""

    def __init__(self, config):
        self.size = tuple(config.SIZE)

    def __call__(self, sample):
        h, w = sample["left"].shape[:2]
        th, tw = self.size
        return _pad_sample(sample, pad_top=th - min(h, th), pad_right=tw - min(w, tw),
                           pad_bottom=0, pad_left=0)


@TRANSFORMS.register
class DivisiblePad:
    """Pad to a multiple of BY and record the pad (`transforms.py:325`)."""

    def __init__(self, config):
        self.by = config.BY
        self.mode = config.get("MODE", "tr")

    def __call__(self, sample):
        h, w = sample["left"].shape[:2]
        pad_h = (-h) % self.by
        pad_w = (-w) % self.by
        if self.mode == "round":
            top, right = pad_h // 2, pad_w // 2
            bottom, left = pad_h - top, pad_w - right
        elif self.mode == "tr":
            top, right, bottom, left = pad_h, pad_w, 0, 0
        else:
            raise ValueError(self.mode)
        sample = _pad_sample(sample, top, right, bottom, left)
        sample["pad"] = np.array([top, right, bottom, left], np.float32)
        return sample


@TRANSFORMS.register
class RandomFlip:
    """horizontal (negates disp) / horizontal_swap (swaps the views, takes the
    right disparity) / vertical (`transforms.py:350`)."""

    def __init__(self, config):
        self.flip_type = config.FLIP_TYPE
        self.prob = config.PROB

    def __call__(self, sample):
        rng = _rng(sample)
        img1, img2, disp = sample["left"], sample["right"], sample["disp"]
        if rng.random() < self.prob and self.flip_type == "horizontal":
            img1 = img1[:, ::-1].copy()
            img2 = img2[:, ::-1].copy()
            disp = (disp[:, ::-1] * -1.0).copy()
        if rng.random() < self.prob and self.flip_type == "horizontal_swap":
            tmp = img1[:, ::-1].copy()
            img1 = img2[:, ::-1].copy()
            disp = sample["disp_right"][:, ::-1].copy()
            img2 = tmp
        if rng.random() < self.prob and self.flip_type == "vertical":
            img1 = img1[::-1].copy()
            img2 = img2[::-1].copy()
            disp = disp[::-1].copy()
        sample["left"], sample["right"], sample["disp"] = img1, img2, disp
        return sample


@TRANSFORMS.register
class RightBottomCrop:
    """Crop to SIZE, anchored at the bottom right (`transforms.py:379`)."""

    def __init__(self, config):
        self.size = tuple(config.SIZE)

    def __call__(self, sample):
        h, w = sample["left"].shape[:2]
        ch, cw = min(h, self.size[0]), min(w, self.size[1])
        for k, v in list(sample.items()):
            if isinstance(v, np.ndarray) and v.ndim >= 2:
                sample[k] = v[h - ch:, w - cw:]
        return sample


@TRANSFORMS.register
class CropOrPad:
    """Pad up or crop down to SIZE (`transforms.py:395`)."""

    def __init__(self, config):
        self.size = tuple(config.SIZE)
        self.crop = RightBottomCrop(config)
        self.pad = RightTopPad(config)

    def __call__(self, sample):
        h, w = sample["left"].shape[:2]
        if self.size[0] > h or self.size[1] > w:
            return self.pad(sample)
        return self.crop(sample)


@TRANSFORMS.register
class NormalizeToMinusOneOne:
    """[0,255] → [-1,1] (`transforms.py:411`)."""

    def __init__(self, config):
        pass

    def __call__(self, sample):
        for k in _IMG_KEYS:
            sample[k] = 2.0 * (sample[k] / 255.0) - 1.0
        return sample
