"""Trainer: the port's counterpart of `openstereo_tpu/runtime/trainer.py:75-428`.

A train step is `model.train()`, the forward and `get_loss`, backward, and
the optimizer's step (clip, update, schedule: `runtime/optim.py`), eager
but for the kernels that the model's training forward runs (STTR's K4,
through its autograd Function; no other model's). BatchNorm takes its statistics per view
and per batch on the one device; with FREEZE_BN it keeps its running
statistics (`models/layers.py:freeze_bn`). Evaluation is `model.eval()`
under `torch.inference_mode()` on the whole batch (STTR reads its
occlusion mask), through the kernels (K1 and K2 on LightStereo and CoEx,
K4 on STTR, K3 on GwcNet and MSNet3D, K2 on MSNet3D and MSNet2D, K3 and K2
on the IGEV family, K3 on FoundationStereo, FastFoundationStereo and
MonSter), with
per-image metrics deduplicated by the sample's dataset index. Checkpoints are `torch.save` files of the train
state, one per epoch, with the MAX_CKPT_SAVE_NUM rotation; resume restores
parameters, BatchNorm statistics, optimizer state and step.

Left out: the mesh and multi-host code (ROADMAP item 20), OPTIMIZATION.REMAT
(whole-forward checkpointing; MODEL.REMAT is ported: GwcNet's and PSMNet's
hourglasses and heads, the IGEV family's GRU iterations)
and visualisation (item 8). TensorBoard scalars are written when
`torch.utils.tensorboard` imports, else the JSONL metrics only.
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..config import Config
from ..data.loader import StereoDataLoader, batch_to_device
from ..device import resolve_device
from ..evaluation import compute_metrics
from ..models import build_model
from ..models.layers import freeze_bn
from ..models.losses import disp_valid_mask
from ..utils import create_logger
from .optim import build_optimizer
from .pretrained import load_state_dict_file, partial_load
from .train_state import TrainState

_CKPT = re.compile(r"^checkpoint_epoch_(\d+)\.pth$")


class Trainer:
    """`device`: the CUDA card unless the caller names the CPU (raises
    without a card). `seed` seeds the model's flax-default initialisation
    and the loaders' orders and augmentations."""

    def __init__(self, cfg: Config, run_dir: str, run_mode: str = "train", seed: int = 3407,
                 num_workers: int = 2, worker_type: str = "thread", logger=None,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self.logger = logger or create_logger(os.path.join(run_dir, "log.txt"))
        self.seed = seed

        opt = cfg.OPTIMIZATION
        if opt.get("REMAT", None):
            raise NotImplementedError("OPTIMIZATION.REMAT (activation checkpointing) is "
                                      "ROADMAP item 8")
        self.use_bf16 = bool(opt.get("AMP", False))
        self.freeze_bn = bool(opt.get("FREEZE_BN", False))
        dtype = torch.bfloat16 if self.use_bf16 else torch.float32
        self.model = build_model(cfg.MODEL, dtype=dtype, device=self.device, seed=seed,
                                 init="train")
        self.max_disp = cfg.EVALUATOR.get("MAX_DISP", cfg.MODEL.get("MAX_DISP", 192))
        self.metric_names = tuple(cfg.EVALUATOR.get("METRIC", ["epe", "d1_all"]))

        batch = int(opt.BATCH_SIZE_PER_GPU)
        eval_batch = int(cfg.EVALUATOR.get("BATCH_SIZE_PER_GPU", batch))
        self.train_loader = None
        if run_mode == "train":
            self.train_loader = StereoDataLoader(cfg.DATA_CONFIG, batch, mode="training",
                                                 seed=seed, num_workers=num_workers,
                                                 worker_type=worker_type)
        self.eval_loader = StereoDataLoader(cfg.DATA_CONFIG, eval_batch, mode="evaluating",
                                            seed=seed, num_workers=num_workers,
                                            worker_type=worker_type)

        self.num_epochs = int(opt.NUM_EPOCHS)
        steps_per_epoch = self.train_loader.steps_per_epoch if self.train_loader else 1
        total_steps = max(1, self.num_epochs * steps_per_epoch)
        optimizer, self.lr_schedule = build_optimizer(opt, total_steps,
                                                      self.model.named_parameters())
        self.state = TrainState(self.model, optimizer)
        self.start_epoch = 0
        n_params = sum(p.numel() for p in self.model.parameters())
        self.logger.info(f"model {cfg.MODEL.NAME}: {n_params / 1e6:.2f}M params, {dtype}, "
                         f"on {self.device}")

        pretrained = cfg.MODEL.get("PRETRAINED_MODEL", "")
        if pretrained:
            self.load_pretrained(load_state_dict_file(pretrained))

        trainer_cfg = cfg.get("TRAINER", {})
        self.ckpt_dir = os.path.join(os.path.abspath(run_dir), "ckpt")
        self.max_ckpts = int(trainer_cfg.get("MAX_CKPT_SAVE_NUM", 30))
        self.metrics_file = os.path.join(run_dir, "metrics.jsonl")
        # per-step losses and times of the last epoch (`train_one_epoch`)
        self.epoch_losses: List[float] = []
        self.epoch_step_ms: List[float] = []
        self.tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.tb = SummaryWriter(os.path.join(run_dir, "tensorboard"))
        except ImportError:
            self.logger.warning("tensorboard unavailable; JSONL metrics only")

    # ------------------------------------------------------------- steps
    def _set_train_mode(self) -> None:
        self.model.train()
        if self.freeze_bn:
            freeze_bn(self.model)

    def train_step(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """One update on a device batch; returns {'loss', 'loss_disp'} (detached)."""
        self._set_train_mode()
        out = self.model(batch)
        loss, info = self.model.get_loss(out, batch)
        self.state.optimizer.zero_grad()
        loss.backward()
        self.state.optimizer.step()
        self.state.step += 1
        return {"loss": loss.detach(), **{k: v.detach() for k, v in info.items()}}

    @torch.inference_mode()
    def eval_step(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """Per-image metrics {name: [B]} of a device batch."""
        self.model.eval()
        disp_pred = self.model(batch)["disp_pred"].float()
        gt = batch["disp"]
        mask = disp_valid_mask(gt, float(self.max_disp))
        if bool(self.cfg.EVALUATOR.get("APPLY_OCC_MASK", False)) and "occ_mask" in batch:
            mask = mask & (batch["occ_mask"] < 0.5)
        return compute_metrics(disp_pred, gt, mask, self.metric_names)

    # ------------------------------------------------------------- loops
    def train_one_epoch(self, epoch: int) -> Dict[str, float]:
        """Every LOGGER_ITER_INTERVAL iterations a log line and a JSONL record
        {'phase': 'train', 'epoch', 'iter', 'lr', 'loss', 'loss_disp'}, with
        the lr of the next step. Afterwards `epoch_losses` and `epoch_step_ms`
        hold every step's loss and time (CUDA events on the card)."""
        if self.train_loader is None:
            raise RuntimeError("the trainer was built with run_mode != 'train'")
        log_int = int(self.cfg.get("TRAINER", {}).get("LOGGER_ITER_INTERVAL", 10))
        cuda = self.device.type == "cuda"
        losses, times = [], []
        last_metrics: Dict[str, float] = {}
        t0 = time.perf_counter()
        for i, batch in enumerate(self.train_loader.epoch(epoch)):
            batch = batch_to_device(batch, self.device)
            t1 = time.perf_counter()
            if cuda:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            metrics = self.train_step(batch)
            if cuda:
                ev[1].record()
                times.append(ev)
            else:
                times.append(1e3 * (time.perf_counter() - t1))
            losses.append(metrics["loss"])
            if i % log_int == 0:
                last_metrics = {k: float(v) for k, v in metrics.items()}
                t2 = time.perf_counter()
                lr = float(self.lr_schedule(self.state.step))
                self.logger.info(
                    f"epoch {epoch} iter {i}/{self.train_loader.steps_per_epoch} "
                    f"loss {last_metrics['loss']:.4f} lr {lr:.2e} "
                    f"data {1e3 * (t1 - t0):.0f}ms step {1e3 * (t2 - t1):.0f}ms")
                self._log_jsonl({"phase": "train", "epoch": epoch, "iter": i, "lr": lr,
                                 **last_metrics})
            t0 = time.perf_counter()
        if cuda:
            torch.cuda.synchronize(self.device)
            times = [a.elapsed_time(b) for a, b in times]
        self.epoch_losses = [float(v) for v in losses]
        self.epoch_step_ms = [float(t) for t in times]
        return last_metrics

    def evaluate(self, epoch: int) -> Dict[str, float]:
        """Mean of the per-image metrics over the evaluation set, each sample
        counted once (the loader's wrap-around padding is dropped by index)."""
        indices, values = [], {m: [] for m in self.metric_names}
        for batch in self.eval_loader.epoch(0):
            metrics = self.eval_step(batch_to_device(batch, self.device))
            indices.append(np.asarray(batch["index"]))
            for m in self.metric_names:
                values[m].append(metrics[m].cpu().numpy())
        if not indices:
            return {}
        idx = np.concatenate(indices)
        _, keep = np.unique(idx, return_index=True)
        results = {m: float(np.concatenate(v)[keep].mean()) for m, v in values.items()}
        self.logger.info(f"eval epoch {epoch}: " +
                         " ".join(f"{m} {v:.4f}" for m, v in results.items()))
        self._log_jsonl({"phase": "eval", "epoch": epoch, **results})
        return results

    def train(self) -> None:
        trainer_cfg = self.cfg.get("TRAINER", {})
        ckpt_int = int(trainer_cfg.get("CKPT_SAVE_INTERVAL", 1))
        eval_int = int(trainer_cfg.get("EVAL_INTERVAL", 1))
        for epoch in range(self.start_epoch, self.num_epochs):
            self.train_one_epoch(epoch)
            if (epoch + 1) % ckpt_int == 0:
                self.save_ckpt(epoch)
            if (epoch + 1) % eval_int == 0:
                self.evaluate(epoch)

    # ------------------------------------------------------------- checkpoints
    def ckpt_path(self, epoch: int) -> str:
        return os.path.join(self.ckpt_dir, f"checkpoint_epoch_{epoch}.pth")

    def saved_epochs(self) -> List[int]:
        if not os.path.isdir(self.ckpt_dir):
            return []
        return sorted(int(m.group(1)) for m in map(_CKPT.match, os.listdir(self.ckpt_dir)) if m)

    def save_ckpt(self, epoch: int) -> str:
        """Write the train state for `epoch` and keep the newest MAX_CKPT_SAVE_NUM."""
        os.makedirs(self.ckpt_dir, exist_ok=True)
        path = self.ckpt_path(epoch)
        torch.save({**self.state.state_dict(), "epoch": epoch}, path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in self.saved_epochs()[:-self.max_ckpts]:
            os.remove(self.ckpt_path(old))
        return path

    def resume_ckpt(self, epoch: Optional[int] = None) -> int:
        """Restore the checkpoint of `epoch` (default: the newest); training
        goes on at the next epoch. Returns that epoch (0 when there is none)."""
        if epoch is None:
            saved = self.saved_epochs()
            if not saved:
                return 0
            epoch = saved[-1]
        sd = torch.load(self.ckpt_path(epoch), map_location=self.device, weights_only=True)
        self.state.load_state_dict(sd)
        self.start_epoch = epoch + 1
        self.logger.info(f"resumed from epoch {epoch}")
        return self.start_epoch

    def load_pretrained(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Shape-checked partial load of a state_dict (parameters and BatchNorm
        statistics alike; `trainer.py:385-405`)."""
        loaded, skipped = partial_load(self.model, state_dict)
        self.logger.info(f"pretrained load: {loaded} tensors, {skipped} skipped")

    # ------------------------------------------------------------- misc
    def _log_jsonl(self, record: Dict) -> None:
        with open(self.metrics_file, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self.tb is not None:
            step = record.get("epoch", 0) * 100000 + record.get("iter", 0)
            prefix = record.get("phase", "train")
            for k, v in record.items():
                if isinstance(v, (int, float)) and k not in ("epoch", "iter"):
                    self.tb.add_scalar(f"{prefix}/{k}", v, step)
