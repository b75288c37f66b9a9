"""Port data pipeline vs the JAX package's, on the CPU: the PFM reader, every
training transform with the same numpy Generator, and the loader on a
synthetic SceneFlow-layout dataset (PNG views, PFM disparities), batch for
batch, for two epochs. All bit-equal.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from openstereo_tpu.config import Config as JConfig
from openstereo_tpu.data import readers as jreaders
from openstereo_tpu.data.loader import StereoDataLoader as JaxLoader
from openstereo_tpu.data.transforms import build_transforms as jax_transforms

from openstereo_tpu_torch.config import Config
from openstereo_tpu_torch.data import readers
from openstereo_tpu_torch.data.loader import StereoDataLoader, batch_to_device
from openstereo_tpu_torch.data.transforms import build_transforms

NORM = {"NAME": "NormalizeImage", "MEAN": [0.485, 0.456, 0.406], "STD": [0.229, 0.224, 0.225]}


@pytest.mark.parametrize("kind", ["Pf little-endian", "PF colour", "Pf big-endian, comment"])
def test_pfm_reader_matches_jax(tmp_path, kind):
    rng = np.random.RandomState(1)
    data = (rng.rand(5, 7, 3) if kind.startswith("PF") else rng.rand(5, 7)).astype(np.float32)
    path = tmp_path / "x.pfm"
    if kind.startswith("Pf big"):
        with open(path, "wb") as f:
            f.write(b"Pf\n# a comment\n7 5\n2.5\n")
            np.flipud(data).astype(">f4").tofile(f)
    else:
        readers.write_pfm(str(path), data)
    got, scale = readers.read_pfm(str(path))
    ref, ref_scale = jreaders.read_pfm(str(path))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, data)
    assert scale == ref_scale
    np.testing.assert_array_equal(readers.read_disp_pfm(str(path)), jreaders.read_disp_pfm(str(path)))


TRANSFORMS = {
    "RandomCrop": [{"NAME": "RandomCrop", "SIZE": [20, 30]}],
    "RandomCrop y-jitter": [{"NAME": "RandomCrop", "SIZE": [20, 30], "Y_JITTER": True}],
    "RandomCrop larger than the image": [{"NAME": "RandomCrop", "SIZE": [40, 30]}],
    "RandomScale": [{"NAME": "RandomScale", "SIZE": [20, 30], "MIN_SCALE": -0.2,
                     "MAX_SCALE": 0.4, "SCALE_PROB": 0.8, "STRETCH_PROB": 0.8}],
    "RandomSparseScale": [{"NAME": "RandomSparseScale", "SIZE": [20, 30], "MIN_SCALE": -0.2,
                           "MAX_SCALE": 0.4, "SCALE_PROB": 1.0}],
    "RandomErase": [{"NAME": "RandomErase", "PROB": 1.0, "MAX_TIME": 3, "BOUNDS": [4, 12]}],
    "StereoColorJitter symmetric": [{"NAME": "StereoColorJitter", "BRIGHTNESS": [0.6, 1.4],
                                     "CONTRAST": [0.6, 1.4], "SATURATION": [0.0, 1.4],
                                     "HUE": 0.5, "ASYMMETRIC_PROB": 0.0}],
    "StereoColorJitter asymmetric": [{"NAME": "StereoColorJitter", "BRIGHTNESS": 0.4,
                                      "CONTRAST": 0.4, "SATURATION": 0.4, "HUE": 0.3,
                                      "ASYMMETRIC_PROB": 1.0}],
    "RandomFlip horizontal": [{"NAME": "RandomFlip", "FLIP_TYPE": "horizontal", "PROB": 0.9}],
    "RandomFlip horizontal_swap": [{"NAME": "RandomFlip", "FLIP_TYPE": "horizontal_swap",
                                    "PROB": 0.9}],
    "RandomFlip vertical": [{"NAME": "RandomFlip", "FLIP_TYPE": "vertical", "PROB": 0.9}],
    "DivisiblePad tr": [{"NAME": "DivisiblePad", "BY": 16}],
    "DivisiblePad round": [{"NAME": "DivisiblePad", "BY": 16, "MODE": "round"}],
    "RightTopPad": [{"NAME": "RightTopPad", "SIZE": [48, 64]}],
    "RightBottomCrop": [{"NAME": "RightBottomCrop", "SIZE": [20, 30]}],
    "CropOrPad crop": [{"NAME": "CropOrPad", "SIZE": [20, 30]}],
    "CropOrPad pad": [{"NAME": "CropOrPad", "SIZE": [40, 60]}],
    "NormalizeToMinusOneOne": [{"NAME": "NormalizeToMinusOneOne"}],
    "TransposeImage, ToTensor, NormalizeImage": [
        {"NAME": "TransposeImage"}, {"NAME": "ToTensor"}, NORM],
    "LightStereo-S training": [{"NAME": "RandomCrop", "SIZE": [24, 40], "Y_JITTER": False}, NORM],
}


def _sample(seed):
    rng = np.random.RandomState(seed)
    disp = (rng.rand(33, 50) * 20).astype(np.float32)
    disp[rng.rand(33, 50) < 0.2] = 0.0
    return {"left": (rng.rand(33, 50, 3) * 255).astype(np.float32),
            "right": (rng.rand(33, 50, 3) * 255).astype(np.float32),
            "disp": disp, "disp_right": (rng.rand(33, 50) * 20).astype(np.float32),
            "occ_mask": rng.rand(33, 50) > 0.8}


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_training_transform_matches_jax(name):
    """The same sample and the same Generator seed through both: bit-equal,
    for several seeds, so every branch of the random draws is taken."""
    spec = TRANSFORMS[name]
    ours, theirs = build_transforms(spec), jax_transforms(spec)
    for seed in range(6):
        sample = _sample(seed)
        got = ours({**{k: v.copy() for k, v in sample.items()},
                    "_rng": np.random.default_rng((7, seed))})
        ref = theirs({**{k: v.copy() for k, v in sample.items()},
                      "_rng": np.random.default_rng((7, seed))})
        assert got.keys() == ref.keys()
        for k in ref:
            if k == "_rng":
                assert got[k].random() == ref[k].random()  # the same draws were taken
                continue
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{name} seed {seed} {k}")


def _write_dataset(root, n=8, hw=(32, 64)):
    """The synthetic SceneFlow layout of `tests/test_trainer_e2e.py`."""
    rng = np.random.RandomState(0)
    lines = []
    for i in range(n):
        for sub in ("left", "right"):
            (root / sub).mkdir(exist_ok=True)
            Image.fromarray(rng.randint(0, 255, (*hw, 3), np.uint8)).save(root / sub / f"{i:04d}.png")
        disp = (rng.rand(*hw) * 12 + 1).astype(np.float32)
        readers.write_pfm(str(root / "left" / f"{i:04d}.pfm"), disp)
        lines.append(f"left/{i:04d}.png right/{i:04d}.png left/{i:04d}.pfm")
    (root / "split.txt").write_text("\n".join(lines))
    return str(root / "split.txt")


def _data_cfg(root, split, **transform):
    return {"DATA_INFOS": [{"DATASET": "SceneFlowDataset", "DATA_PATH": str(root),
                            "DATA_SPLIT": {"TRAINING": split, "EVALUATING": split},
                            "RETURN_RIGHT_DISP": False}],
            "DATA_TRANSFORM": {"TRAINING": [{"NAME": "RandomCrop", "SIZE": [24, 40]}, NORM],
                               "EVALUATING": [{"NAME": "RightTopPad", "SIZE": [32, 64]}, NORM],
                               **transform}}


LOADERS = {
    "training, RandomCrop": ("training", {}),
    "training, batch-uniform crop": ("training", {"BATCH_UNIFORM": True, "RANDOM_TYPE": "range",
                                                  "H_RANGE": [0.5, 1.0], "W_RANGE": [0.5, 1.0]}),
    "evaluating": ("evaluating", {}),
}


@pytest.mark.parametrize("case", list(LOADERS))
def test_loader_matches_jax(tmp_path, case):
    """Batch size 3 over 8 samples: wrap-around padding, two epochs, two workers."""
    mode, extra = LOADERS[case]
    d = _data_cfg(tmp_path, _write_dataset(tmp_path), **extra)
    ours = StereoDataLoader(Config.from_dict(d), 3, mode=mode, seed=5, num_workers=2)
    theirs = JaxLoader(JConfig.from_dict(d), 3, mode=mode, seed=5, num_workers=2)
    assert len(ours) == len(theirs) == 3
    for epoch in range(2):
        got, ref = list(ours.epoch(epoch)), list(theirs.epoch(epoch))
        assert len(got) == len(ref) == 3
        for g, r in zip(got, ref):
            assert g.keys() == r.keys()
            for k in r:
                if isinstance(r[k], list):
                    assert g[k] == r[k]
                else:
                    assert g[k].dtype == r[k].dtype and g[k].shape == r[k].shape, k
                    np.testing.assert_array_equal(g[k], r[k], err_msg=f"epoch {epoch} {k}")
    if mode == "training":
        assert not np.array_equal(list(ours.epoch(0))[0]["index"], list(ours.epoch(1))[0]["index"])


def test_batch_to_device_layout(tmp_path):
    d = _data_cfg(tmp_path, _write_dataset(tmp_path, n=2))
    batch = next(StereoDataLoader(Config.from_dict(d), 2, seed=1).epoch(0))
    t = batch_to_device(batch, torch.device("cpu"))
    assert t["left"].shape == (2, 3, 24, 40) and t["left"].is_contiguous()
    np.testing.assert_array_equal(t["left"].permute(0, 2, 3, 1).numpy(), batch["left"])
    assert t["disp"].shape == (2, 24, 40) and t["valid"].dtype == torch.float32
    assert t["index"].tolist() == list(batch["index"]) and t["name"] == batch["name"]


def test_loader_refuses_unported_modes(tmp_path):
    d = Config.from_dict(_data_cfg(tmp_path, _write_dataset(tmp_path, n=1)))
    with pytest.raises(NotImplementedError, match="item 8"):
        StereoDataLoader(d, 1, worker_type="process")
    with pytest.raises(NotImplementedError, match="item 20"):
        StereoDataLoader(d, 1, process_count=2)
