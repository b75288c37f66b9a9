"""Train state (counterpart of `openstereo_tpu/runtime/train_state.py:12`):
the model (its parameters and BatchNorm statistics), the optimizer and the
step, with one `state_dict()` for checkpoints."""

from __future__ import annotations

from typing import Dict

import torch

from .optim import Optimizer


class TrainState:
    def __init__(self, model: torch.nn.Module, optimizer: Optimizer, step: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.step = step

    def state_dict(self) -> Dict:
        """{'model_state', 'optimizer_state', 'step'}: 'model_state' is the
        reference OpenStereo key, so a checkpoint also loads as pretrained
        weights."""
        return {"model_state": self.model.state_dict(),
                "optimizer_state": self.optimizer.state_dict(), "step": self.step}

    def load_state_dict(self, sd: Dict) -> None:
        self.model.load_state_dict(sd["model_state"])
        self.optimizer.load_state_dict(sd["optimizer_state"])
        self.step = int(sd["step"])
