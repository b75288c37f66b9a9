"""The port's evaluation datasets, readers and the eval and measure CLIs, on the CPU.

KITTI, DrivingStereo, Middlebury and ETH3D sets are written as synthetic
files in each format (PNG views, uint16 PNG disparities ×256, PFM
disparities with inf, non-occlusion mask PNGs); each port dataset's samples
after the evaluation transforms of `cfgs/kitti15_eval.yaml` (RightTopPad and
NormalizeImage, here at a small pad) are bit-equal to the JAX dataset's.
The eval CLI runs a tiny LightStereo (max_disp 16, blocks (1,1,1), expanse
2) on two Middlebury-format pairs and must give the metrics of the port's
`Trainer.evaluate` called directly, with and without APPLY_OCC_MASK; the
measure CLI prints the parameters and FLOPs of the same model.
"""

import json

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from openstereo_tpu.config import Config as JConfig
from openstereo_tpu.data import datasets as jdatasets
from openstereo_tpu.data import readers as jreaders

from openstereo_tpu_torch.config import Config, load_config
from openstereo_tpu_torch.data import datasets, readers
from openstereo_tpu_torch.models import build_model
from openstereo_tpu_torch.runtime import Trainer
from openstereo_tpu_torch.tools import eval as eval_cli
from openstereo_tpu_torch.tools import measure

from test_torch_data import NORM
from torch_port_threads import torch_threads_per_worker  # noqa: F401 (autouse fixture)

HW = (30, 52)  # the synthetic images; padded to PAD by RightTopPad
PAD = [32, 64]
TINY_MODEL = {"NAME": "LightStereo", "MAX_DISP": 16, "AGGREGATION_BLOCKS": [1, 1, 1],
              "EXPANSE_RATIO": 2, "LEFT_ATT": True}


def _png(path, a):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(a).save(path)


def _image(rng):
    return rng.randint(0, 256, (*HW, 3), np.uint8)


def _disp_png(rng):
    """A KITTI disparity: uint16 of disparity × 256, 0 (invalid) at a fifth of
    the pixels, and the largest code."""
    d = (rng.rand(*HW) * 40 * 256).astype(np.uint16)
    d[rng.rand(*HW) < 0.2] = 0
    d[0, 0] = 65535
    return d


def _disp_pfm(rng, path):
    d = (rng.rand(*HW) * 30).astype(np.float32)
    d[rng.rand(*HW) < 0.1] = np.inf
    path.parent.mkdir(parents=True, exist_ok=True)
    readers.write_pfm(str(path), d)


def _mask(rng):
    """A non-occlusion mask: 255 visible, 128 occluded, 0 invalid."""
    return rng.choice(np.array([255, 128, 0], np.uint8), size=HW, p=[0.6, 0.3, 0.1])


def write_kitti(root, n=2, seed=0):
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(n):
        name = f"{i:06d}_10.png"
        _png(root / "training/image_2" / name, _image(rng))
        _png(root / "training/image_3" / name, _image(rng))
        for sub in ("disp_occ_0", "disp_noc_0", "disp_occ_1", "disp_noc_1"):
            _png(root / "training" / sub / name, _disp_png(rng))
        lines.append(f"training/image_2/{name} training/image_3/{name} training/disp_occ_0/{name}")
    return lines


def write_driving(root, n=2, seed=1):
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(n):
        name = f"2018-07-09-16-11-56_{i:03d}.png"
        _png(root / "left" / name, _image(rng))
        _png(root / "right" / name, _image(rng))
        _png(root / "disparity" / name, _disp_png(rng))
        lines.append(f"left/{name} right/{name} disparity/{name}")
    return lines


def write_middlebury(root, n=2, seed=2):
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(n):
        scene = root / "trainingQ" / f"Scene{i}"
        _png(scene / "im0.png", _image(rng))
        _png(scene / "im1.png", _image(rng))
        _disp_pfm(rng, scene / "disp0GT.pfm")
        _png(scene / "mask0nocc.png", _mask(rng))
        s = f"trainingQ/Scene{i}"
        lines.append(f"{s}/im0.png {s}/im1.png {s}/disp0GT.pfm")
    return lines


def write_eth3d(root, n=2, seed=3):
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(n):
        scene, gt = root / "two_view_training" / f"s{i}", root / "two_view_training_gt" / f"s{i}"
        _png(scene / "im0.png", _image(rng))
        _png(scene / "im1.png", _image(rng))
        _disp_pfm(rng, gt / "disp0GT.pfm")
        _png(gt / "mask0nocc.png", _mask(rng))
        lines.append(f"two_view_training/s{i}/im0.png two_view_training/s{i}/im1.png "
                     f"two_view_training_gt/s{i}/disp0GT.pfm")
    return lines


WRITERS = {"KittiDataset": write_kitti, "DrivingDataset": write_driving,
           "MiddleburyDataset": write_middlebury, "ETH3DDataset": write_eth3d}
CASES = {
    "KITTI": ("KittiDataset", {}),
    "KITTI, USE_NOC and RETURN_RIGHT_DISP": ("KittiDataset", {"USE_NOC": True,
                                                              "RETURN_RIGHT_DISP": True}),
    "DrivingStereo": ("DrivingDataset", {}),
    "Middlebury": ("MiddleburyDataset", {}),
    "ETH3D": ("ETH3DDataset", {}),
}


def data_cfg(root, dataset, split, **info):
    """DATA_CONFIG with `cfgs/kitti15_eval.yaml`'s evaluation transforms at PAD."""
    return {"DATA_INFOS": [{"DATASET": dataset, "DATA_PATH": str(root),
                            "DATA_SPLIT": {"EVALUATING": str(split)}, **info}],
            "DATA_TRANSFORM": {"EVALUATING": [{"NAME": "RightTopPad", "SIZE": PAD}, NORM]}}


def write_set(root, dataset):
    lines = WRITERS[dataset](root)
    split = root / "split.txt"
    split.write_text("\n".join(lines) + "\n")
    return split


@pytest.mark.parametrize("case", list(CASES))
def test_eval_dataset_matches_jax(tmp_path, case):
    dataset, info = CASES[case]
    d = data_cfg(tmp_path, dataset, write_set(tmp_path, dataset), **info)
    ours = datasets.__dict__[dataset](Config.from_dict(d["DATA_INFOS"][0]), Config.from_dict(d),
                                      "evaluating")
    theirs = jdatasets.__dict__[dataset](JConfig.from_dict(d["DATA_INFOS"][0]),
                                         JConfig.from_dict(d), "evaluating")
    assert len(ours) == len(theirs) == 2
    for i in range(2):
        got, ref = ours.load(i), theirs.load(i)
        assert got.keys() == ref.keys()
        for k in ref:
            if isinstance(ref[k], np.ndarray):
                assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
                np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{case} {i} {k}")
            else:
                assert got[k] == ref[k], k
        assert got["left"].shape == (*PAD, 3) and got["disp"].shape == tuple(PAD)
    sample = ours.load(0)
    if dataset in ("MiddleburyDataset", "ETH3DDataset"):
        assert "occ_mask" in sample and 0 < sample["occ_mask"].mean() < 1
        assert np.isfinite(sample["disp"]).all()  # inf → 0
    if info.get("RETURN_RIGHT_DISP"):
        assert "disp_right" in sample


def test_kitti_use_noc_reads_the_noc_disparity(tmp_path):
    split = write_set(tmp_path, "KittiDataset")
    samples = {}
    for noc in (False, True):
        d = data_cfg(tmp_path, "KittiDataset", split, USE_NOC=noc)
        samples[noc] = datasets.KittiDataset(Config.from_dict(d["DATA_INFOS"][0]),
                                             Config.from_dict(d), "evaluating").load(0)
    noc = readers.read_disp_png_scaled(str(tmp_path / "training/disp_noc_0/000000_10.png"))
    np.testing.assert_array_equal(samples[True]["disp"][PAD[0] - HW[0]:, :HW[1]], noc)
    assert not np.array_equal(samples[True]["disp"], samples[False]["disp"])


def test_read_disp_png_scaled_matches_jax(tmp_path):
    d = _disp_png(np.random.RandomState(4))
    _png(tmp_path / "d.png", d)
    for divisor in (256.0, 100.0):
        got = readers.read_disp_png_scaled(str(tmp_path / "d.png"), divisor)
        ref = jreaders.read_disp_png_scaled(str(tmp_path / "d.png"), divisor)
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(readers.read_disp_png_scaled(str(tmp_path / "d.png")) * 256.0, d)


# ------------------------------------------------------------------- the CLIs

def _cli_configs(root, occ):
    """A tiny LightStereo config (its own SceneFlow DATA_CONFIG, which the eval
    data config replaces) and a Middlebury eval data config."""
    split = write_set(root, "MiddleburyDataset")
    model_cfg = {
        "DATA_CONFIG": {"DATA_INFOS": [{"DATASET": "SceneFlowDataset", "DATA_PATH": "/nowhere",
                                        "DATA_SPLIT": {"EVALUATING": "/nowhere/split.txt"}}],
                        "DATA_TRANSFORM": {"EVALUATING": [{"NAME": "RightTopPad",
                                                           "SIZE": [64, 128]}]}},
        "MODEL": TINY_MODEL,
        "OPTIMIZATION": {"AMP": False, "BATCH_SIZE_PER_GPU": 1, "NUM_EPOCHS": 1,
                         "OPTIMIZER": {"NAME": "AdamW", "LR": 1.0e-3},
                         "SCHEDULER": {"NAME": "OneCycleLR", "MAX_LR": 1.0e-3}},
        "EVALUATOR": {"BATCH_SIZE_PER_GPU": 1, "MAX_DISP": 192, "METRIC": ["epe"]},
    }
    eval_cfg = {"DATA_CONFIG": data_cfg(root, "MiddleburyDataset", split),
                "EVALUATOR": {"BATCH_SIZE_PER_GPU": 2, "MAX_DISP": 16, "APPLY_OCC_MASK": occ,
                              "METRIC": ["d1_all", "epe", "thres_1", "thres_2", "thres_3"]}}
    paths = {}
    for name, cfg in (("model", model_cfg), ("eval", eval_cfg)):
        paths[name] = root / f"{name}.yaml"
        paths[name].write_text(yaml.safe_dump(cfg))
    return paths


@pytest.mark.parametrize("occ", [True, False])
def test_eval_cli_matches_trainer_evaluate(tmp_path, occ):
    paths = _cli_configs(tmp_path, occ)
    run_dir = tmp_path / "run"
    trainer, metrics = eval_cli.main(
        ["--cfg_file", str(paths["model"]), "--eval_data_cfg_file", str(paths["eval"]),
         "--run_dir", str(run_dir), "--data_paths", str(tmp_path / "none.yaml"), "--workers", "2",
         "--device", "cpu"])
    assert trainer.cfg.EVALUATOR.APPLY_OCC_MASK is occ
    assert len(trainer.eval_loader) == 1 and trainer.eval_loader.batch_size == 2
    cfg = load_config(str(paths["model"]))
    ecfg = load_config(str(paths["eval"]))
    cfg["DATA_CONFIG"], cfg["EVALUATOR"] = ecfg.DATA_CONFIG, ecfg.EVALUATOR
    direct = Trainer(cfg, str(tmp_path / "direct"), run_mode="eval", device="cpu").evaluate(0)
    assert set(metrics) == {"d1_all", "epe", "thres_1", "thres_2", "thres_3"}
    assert metrics == direct
    records = [json.loads(ln) for ln in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert records == [{"phase": "eval", "epoch": 0, **metrics}]
    # the occlusion mask takes pixels out of the means
    other, ecfg = load_config(str(paths["model"])), load_config(str(paths["eval"]))
    ecfg["EVALUATOR"]["APPLY_OCC_MASK"] = not occ
    other["DATA_CONFIG"], other["EVALUATOR"] = ecfg.DATA_CONFIG, ecfg.EVALUATOR
    flipped = Trainer(other, str(tmp_path / "flipped"), run_mode="eval", device="cpu").evaluate(0)
    assert flipped["epe"] != metrics["epe"]


def test_eval_cli_loads_pretrained_weights(tmp_path):
    paths = _cli_configs(tmp_path, True)
    src = build_model(Config.from_dict(TINY_MODEL), device="cpu", seed=11)
    torch.save({"model_state": src.state_dict()}, tmp_path / "w.pth")
    trainer, _ = eval_cli.main(
        ["--cfg_file", str(paths["model"]), "--eval_data_cfg_file", str(paths["eval"]),
         "--run_dir", str(tmp_path / "run"), "--pretrained", str(tmp_path / "w.pth"),
         "--ckpt", "-1", "--data_paths", str(tmp_path / "none.yaml"), "--device", "cpu"])
    got = trainer.model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in src.state_dict().items())


def test_measure_cli_on_cpu(tmp_path, capsys):
    paths = _cli_configs(tmp_path, False)
    out = measure.main(["--cfg_file", str(paths["model"]), "--shape", "32", "64", "--reps", "1",
                        "--warmup", "0", "--f32", "--device", "cpu"])
    model = build_model(Config.from_dict(TINY_MODEL), device="cpu")
    assert out["params"] == sum(p.numel() for p in model.parameters())
    assert out["flops"] > 0 and out["ms"] > 0
    printed = capsys.readouterr().out
    assert f"params: {out['params'] / 1e6:.2f}M ({out['params']})" in printed
    assert f"flops: {out['flops'] / 1e9:.1f}G ({out['flops']})" in printed
    assert "cpu" in printed


def test_cli_without_a_card_raises(tmp_path, monkeypatch):
    paths = _cli_configs(tmp_path, False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_cli.main(["--cfg_file", str(paths["model"]), "--run_dir", str(tmp_path / "run")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        measure.main(["--cfg_file", str(paths["model"])])
    with pytest.raises(NotImplementedError, match="item 8"):
        eval_cli.main(["--cfg_file", str(paths["model"]), "--eval_data_cfg_file",
                       str(paths["eval"]), "--run_dir", str(tmp_path / "run"),
                       "--worker_type", "process", "--device", "cpu"])
