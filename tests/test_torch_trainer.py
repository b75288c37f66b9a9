"""The port's Trainer and training CLIs on the CPU (`device="cpu"`), on a
synthetic SceneFlow-layout dataset (8 PNG pairs, PFM disparities), with a
tiny LightStereo (max_disp 16, blocks (1,1,1), expanse 2, 32×64)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from openstereo_tpu_torch.config import Config, load_config
from openstereo_tpu_torch.models import build_model, fan_in
from openstereo_tpu_torch.runtime import Trainer
from openstereo_tpu_torch.tools import overfit_check, train

from test_torch_data import NORM, _write_dataset

ROOT = Path(__file__).resolve().parents[1]


def _cfg(root, split, epochs=2, **trainer):
    return {
        "DATA_CONFIG": {
            "DATA_INFOS": [{"DATASET": "SceneFlowDataset", "DATA_PATH": str(root),
                            "DATA_SPLIT": {"TRAINING": split, "EVALUATING": split},
                            "RETURN_RIGHT_DISP": False}],
            "DATA_TRANSFORM": {"TRAINING": [{"NAME": "RandomCrop", "SIZE": [32, 64]}, NORM],
                               "EVALUATING": [{"NAME": "RightTopPad", "SIZE": [32, 64]}, NORM]},
        },
        "MODEL": {"NAME": "LightStereo", "MAX_DISP": 16, "AGGREGATION_BLOCKS": [1, 1, 1],
                  "EXPANSE_RATIO": 2, "LEFT_ATT": True},
        "OPTIMIZATION": {
            "AMP": False, "BATCH_SIZE_PER_GPU": 3, "NUM_EPOCHS": epochs,
            "OPTIMIZER": {"NAME": "AdamW", "LR": 1.0e-3, "WEIGHT_DECAY": 1.0e-5},
            "SCHEDULER": {"NAME": "OneCycleLR", "MAX_LR": 1.0e-3, "PCT_START": 0.1},
            "CLIP_GRAD": {"TYPE": "value", "CLIP_VALUE": 0.1},
        },
        "EVALUATOR": {"BATCH_SIZE_PER_GPU": 3, "MAX_DISP": 16,
                      "METRIC": ["epe", "d1_all", "thres_1"]},
        "TRAINER": {"EVAL_INTERVAL": 1, "CKPT_SAVE_INTERVAL": 1, "MAX_CKPT_SAVE_NUM": 1,
                    "LOGGER_ITER_INTERVAL": 2, **trainer},
    }


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    return root, _write_dataset(root)


@pytest.fixture(scope="module")
def trained(dataset, tmp_path_factory):
    run_dir = tmp_path_factory.mktemp("run")
    trainer = Trainer(Config.from_dict(_cfg(*dataset)), str(run_dir), seed=1, device="cpu")
    trainer.train()
    return trainer, run_dir


def test_trainer_two_epochs_with_evaluation(trained):
    trainer, run_dir = trained
    assert trainer.state.step == 6 and trainer.state.optimizer.count == 6  # 8 samples, batch 3
    records = [json.loads(ln) for ln in (run_dir / "metrics.jsonl").read_text().splitlines()]
    train_recs = [r for r in records if r["phase"] == "train"]
    evals = [r for r in records if r["phase"] == "eval"]
    assert [(r["epoch"], r["iter"]) for r in train_recs] == [(0, 0), (0, 2), (1, 0), (1, 2)]
    for r in train_recs:
        assert set(r) == {"phase", "epoch", "iter", "lr", "loss", "loss_disp"}
        assert np.isfinite(r["loss"]) and r["loss"] == r["loss_disp"]
    # the lr logged after step 1 is that of step 1 (the count after the update)
    assert train_recs[0]["lr"] == pytest.approx(trainer.lr_schedule(1))
    assert [r["epoch"] for r in evals] == [0, 1]
    for r in evals:
        assert set(r) == {"phase", "epoch", "epe", "d1_all", "thres_1"}
        assert all(np.isfinite(r[m]) for m in ("epe", "d1_all", "thres_1"))
    assert len(trainer.epoch_losses) == len(trainer.epoch_step_ms) == 3
    assert (run_dir / "log.txt").exists()


def test_evaluation_counts_each_sample_once(trained):
    """9 evaluated slots (3 batches of 3) for 8 samples: the padded one is dropped."""
    trainer, _ = trained
    per_image = []
    for batch in trainer.eval_loader.epoch(0):
        from openstereo_tpu_torch.data.loader import batch_to_device

        m = trainer.eval_step(batch_to_device(batch, trainer.device))
        per_image += list(zip(batch["index"], m["epe"].tolist()))
    assert len(per_image) == 9
    mean = np.mean([v for i, v in dict(per_image).items()])
    assert trainer.evaluate(9)["epe"] == pytest.approx(mean, rel=1e-6)


def test_checkpoint_rotation_and_resume(trained, dataset):
    trainer, run_dir = trained
    assert trainer.saved_epochs() == [1]  # MAX_CKPT_SAVE_NUM 1
    saved = torch.load(trainer.ckpt_path(1), weights_only=True)
    assert saved["step"] == 6 and saved["epoch"] == 1
    again = Trainer(Config.from_dict(_cfg(*dataset)), str(run_dir), seed=2, device="cpu")
    assert again.resume_ckpt() == 2 and again.start_epoch == 2
    assert again.state.step == 6 and again.state.optimizer.count == 6
    for k, v in saved["model_state"].items():
        assert torch.equal(again.model.state_dict()[k], v), k
    for k, st in saved["optimizer_state"]["state"].items():
        for s, t in st.items():
            assert torch.equal(again.state.optimizer.state[k][s], t), (k, s)
    assert torch.equal(again.model.state_dict()["backbone.bn1.running_var"],
                       trainer.model.state_dict()["backbone.bn1.running_var"])


def test_pretrained_partial_load(trained, dataset, tmp_path):
    trainer, _ = trained
    sd = {f"module.{k}": v for k, v in trainer.model.state_dict().items()}
    sd["module.backbone.conv_stem.weight"] = torch.zeros(1, 2, 3)  # wrong shape: skipped
    sd["module.no.such.key"] = torch.zeros(1)
    torch.save({"model_state": sd}, tmp_path / "ref.pth")
    cfg = _cfg(*dataset)
    cfg["MODEL"]["PRETRAINED_MODEL"] = str(tmp_path / "ref.pth")
    fresh = Trainer(Config.from_dict(cfg), str(tmp_path / "run"), seed=5, device="cpu")
    a, b = fresh.model.state_dict(), trainer.model.state_dict()
    assert not torch.equal(a["backbone.conv_stem.weight"], b["backbone.conv_stem.weight"])
    assert all(torch.equal(a[k], b[k]) for k in a if k != "backbone.conv_stem.weight")


def test_freeze_bn_trainer_keeps_statistics(dataset, tmp_path):
    cfg = _cfg(*dataset, epochs=1)
    cfg["OPTIMIZATION"]["FREEZE_BN"] = True
    trainer = Trainer(Config.from_dict(cfg), str(tmp_path), seed=1, device="cpu")
    before = {k: v.clone() for k, v in trainer.model.state_dict().items() if "running" in k}
    w0 = trainer.model.backbone.bn1.weight.detach().clone()
    trainer.train_one_epoch(0)
    after = trainer.model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())
    assert not torch.equal(trainer.model.backbone.bn1.weight, w0)


def test_train_cli_on_cpu(dataset, tmp_path):
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(_cfg(*dataset, epochs=1)))
    args = ["--cfg_file", str(tmp_path / "tiny.yaml"), "--save_root", str(tmp_path / "out"),
            "--device", "cpu", "--data_paths", str(tmp_path / "none.yaml"), "--workers", "1"]
    trainer = train.main(args)
    run_dir = tmp_path / "out" / "SceneFlow" / "LightStereo" / "tiny" / "default"
    assert trainer.run_dir == str(run_dir) and trainer.saved_epochs() == [0]
    assert trainer.device.type == "cpu" and trainer.state.step == 3
    # a second run resumes after the last saved epoch and has nothing left to do
    again = train.main(args)
    assert again.start_epoch == 1 and again.state.step == 3


def test_training_init_is_flax_default():
    """BN identity, zero biases, kernels truncated-normal with variance 1/fan_in
    (std within 10 % for kernels of 4096+ elements, the transposed convs' fan_in
    over (in, kh, kw) as flax counts it)."""
    cfg = load_config(str(ROOT / "cfgs/lightstereo/lightstereo_s_sceneflow.yaml"))
    model = build_model(cfg.MODEL, device="cpu", seed=0, init="train")
    n_big = n_deconv = 0
    for name, m in model.named_modules():
        if isinstance(m, (torch.nn.BatchNorm2d,)):
            assert torch.all(m.weight == 1) and torch.all(m.bias == 0), name
            assert torch.all(m.running_mean == 0) and torch.all(m.running_var == 1), name
        elif isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            if m.bias is not None:
                assert torch.all(m.bias == 0), name
            w = m.weight.detach()
            bound = 2 * fan_in(m) ** -0.5 / 0.87962566103423978
            assert w.abs().max() <= bound + 1e-6, name
            if w.numel() >= 4096:
                n_big += 1
                assert abs(w.std().item() * fan_in(m) ** 0.5 - 1) < 0.1, name
            if isinstance(m, torch.nn.ConvTranspose2d):
                n_deconv += 1
                assert fan_in(m) == m.in_channels * m.kernel_size[0] * m.kernel_size[1]
    assert n_big > 20 and n_deconv == 7
    again = build_model(cfg.MODEL, device="cpu", seed=0, init="train").state_dict()
    assert all(torch.equal(v, again[k]) for k, v in model.state_dict().items())


def test_entry_points_raise_without_a_card(monkeypatch, dataset, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "tiny.yaml").write_text(yaml.safe_dump(_cfg(*dataset)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--cfg_file", str(tmp_path / "tiny.yaml"), "--save_root", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        overfit_check.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(Config.from_dict(_cfg(*dataset)), str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(Config.from_dict(_cfg(*dataset)), str(tmp_path), device="cuda")


def test_overfit_check_cli_on_cpu():
    res = overfit_check.main(["--steps", "3", "--batch", "1", "--size", "32", "64",
                              "--max_disp", "16", "--device", "cpu",
                              "--kwargs", '{"AGGREGATION_BLOCKS": [1, 1, 1], "EXPANSE_RATIO": 2}'])
    assert [t[0] for t in res["trajectory"]] == [0, 2]  # every 25th step and the last
    assert all(np.isfinite(t[1]) and np.isfinite(t[2]) for t in res["trajectory"])
    assert res["final_epe"] == res["trajectory"][-1][2]


def test_stereogram_matches_jax_tool():
    import importlib.util

    spec = importlib.util.spec_from_file_location("jax_overfit_check",
                                                  ROOT / "tools" / "overfit_check.py")
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    jax_make_stereogram = jax_tool.make_stereogram

    for a, b in zip(overfit_check.make_stereogram(np.random.RandomState(3), 32, 64, 16),
                    jax_make_stereogram(np.random.RandomState(3), 32, 64, 16)):
        np.testing.assert_array_equal(a, b)
