"""Host-side batch loader: the port's copy of `openstereo_tpu/data/loader.py:39-250`,
with thread workers, and the adapter that hands a batch to the model.

- the datasets of DATA_INFOS are concatenated;
- the epoch order is `default_rng((seed, epoch)).permutation` (training),
  padded by wrapping to whole batches, and every sample draws its
  augmentations from `default_rng((seed, epoch, flat_idx))`, so any worker
  layout gives the JAX loader's batches;
- with BATCH_UNIFORM the crop size is drawn once per batch, in batch order,
  from `default_rng((seed, epoch, 0xB17C4))`;
- `num_workers` threads decode a batch's samples and a producer thread keeps
  `prefetch` batches ahead. Process workers and more than one process are
  ROADMAP items 8 and 20.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import Config
from ..registry import DATASETS
from . import datasets  # noqa: F401  (registers the dataset classes)
from .datasets import DatasetTemplate
from .transforms import RandomCrop


def build_datasets(data_cfg: Config, mode: str) -> List[DatasetTemplate]:
    return [DATASETS.get(info.DATASET)(data_info=info, data_cfg=data_cfg, mode=mode)
            for info in data_cfg.DATA_INFOS]


class StereoDataLoader:
    def __init__(self, data_cfg: Config, batch_size: int, mode: str = "training",
                 seed: int = 0, process_index: int = 0, process_count: int = 1,
                 num_workers: int = 2, prefetch: int = 2, worker_type: str = "thread"):
        if worker_type != "thread":
            raise NotImplementedError(
                f"worker_type {worker_type!r}: process workers are ROADMAP item 8")
        if process_count != 1:
            raise NotImplementedError("more than one process is ROADMAP item 20 (DDP)")
        self.datasets = build_datasets(data_cfg, mode)
        self.mode = mode
        self.batch_size = batch_size
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.shuffle = mode == "training"
        self._index: List[Tuple[int, int]] = [(di, i) for di, ds in enumerate(self.datasets)
                                              for i in range(len(ds))]
        tcfg = data_cfg.DATA_TRANSFORM
        self.batch_uniform = bool(tcfg.get("BATCH_UNIFORM", False)) and self.shuffle
        self.random_type = tcfg.get("RANDOM_TYPE", None)
        self.h_range = tcfg.get("H_RANGE", None)
        self.w_range = tcfg.get("W_RANGE", None)

    def __len__(self) -> int:
        """Batches per epoch for this process."""
        n = len(self._index)
        per_proc = -(-n // self.process_count) if n else 0
        return -(-per_proc // self.batch_size) if per_proc else 0

    @property
    def steps_per_epoch(self) -> int:
        return len(self)

    def _epoch_order(self, epoch: int) -> np.ndarray:
        n = len(self._index)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng((self.seed, epoch)).permutation(n)
        chunk = self.process_count * self.batch_size
        pad = (-n) % chunk
        if pad:
            order = np.concatenate([order, order[:pad]])
        return order[self.process_index::self.process_count]

    def _crops(self) -> List[RandomCrop]:
        return [t for ds in self.datasets for t in ds.transform.transforms
                if isinstance(t, RandomCrop)]

    def _draw_crop_size(self, rng: np.random.Generator) -> Optional[Tuple[int, int]]:
        """Per-batch crop size (`loader.py:114`)."""
        crops = self._crops()
        if not crops:
            return None
        base_h, base_w = crops[0].base_size
        if self.random_type == "range":
            w = int(rng.integers(int(self.w_range[0] * base_w), int(self.w_range[1] * base_w) + 1))
            h = int(rng.integers(int(self.h_range[0] * base_h), int(self.h_range[1] * base_h) + 1))
        elif self.random_type == "choice":
            w = (int(rng.choice(self.w_range)) if isinstance(self.w_range, (list, tuple))
                 else int(self.w_range))
            h = (int(rng.choice(self.h_range)) if isinstance(self.h_range, (list, tuple))
                 else int(self.h_range))
        else:
            raise ValueError(self.random_type)
        return (h, w)

    def _apply_crop_size(self, hw: Optional[Tuple[int, int]]):
        if hw is not None:
            for c in self._crops():
                c.crop_size = hw

    def _load_one(self, flat_idx: int, epoch: int) -> Dict:
        di, li = self._index[flat_idx]
        rng = np.random.default_rng((self.seed, epoch, flat_idx))
        sample = self.datasets[di].load(li, rng=rng)
        sample["index"] = flat_idx
        return sample

    @staticmethod
    def collate(samples: Sequence[Dict]) -> Dict:
        batch: Dict = {}
        for k in samples[0]:
            vals = [s[k] for s in samples]
            if isinstance(vals[0], np.ndarray):
                batch[k] = np.stack(vals).astype(np.float32)
            elif isinstance(vals[0], (int, float, np.integer, np.floating)):
                batch[k] = np.asarray(vals)
            else:  # names
                batch[k] = vals
        return batch

    def epoch(self, epoch: int = 0) -> Iterator[Dict]:
        """The epoch's batches of NHWC float32 numpy arrays (`loader.py:155`)."""
        order = self._epoch_order(epoch)
        n_batches = len(order) // self.batch_size
        batch_rng = np.random.default_rng((self.seed, epoch, 0xB17C4))

        def make_batch(b: int, pool) -> Dict:
            # the crop size is drawn in batch order, before the batch's samples load
            crop_hw = self._draw_crop_size(batch_rng) if self.batch_uniform else None
            idxs = [int(i) for i in order[b * self.batch_size:(b + 1) * self.batch_size]]
            self._apply_crop_size(crop_hw)
            if pool is None or len(idxs) <= 1:
                samples = [self._load_one(i, epoch) for i in idxs]
            else:
                samples = list(pool.map(lambda i: self._load_one(i, epoch), idxs))
            return self.collate(samples)

        if self.num_workers <= 1 or n_batches <= 1:
            for b in range(n_batches):
                yield make_batch(b, None)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            def producer():
                try:
                    for b in range(n_batches):
                        if stop.is_set():
                            return
                        q.put(make_batch(b, pool))
                except BaseException as e:  # re-raised in the consumer
                    q.put(e)
                finally:
                    q.put(None)

            t = threading.Thread(target=producer, daemon=True)
            t.start()
            try:
                while True:
                    item = q.get()
                    if item is None:
                        break
                    if isinstance(item, BaseException):
                        raise item
                    yield item
            finally:
                stop.set()
                while t.is_alive():  # unblock a producer waiting on a full queue
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        t.join(0.01)


_IMAGE_KEYS = ("left", "right")


def batch_to_device(batch: Dict, device: torch.device) -> Dict:
    """NHWC float32 numpy batch → tensors on `device`: images [B,3,H,W],
    maps [B,H,W] (disparities, 'valid', masks), 'index' [B]; names stay a
    list. The copy goes over in NHWC (pinned, non-blocking on the card) and
    is made NCHW there."""
    device = torch.device(device)
    out: Dict = {}
    for k, v in batch.items():
        if not isinstance(v, np.ndarray):
            out[k] = v
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        if k in _IMAGE_KEYS:
            t = t.permute(0, 3, 1, 2).contiguous()
        out[k] = t
    return out
