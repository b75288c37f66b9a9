"""Pretrained weights (counterpart of `openstereo_tpu/runtime/pretrained.py`).

The port keeps the reference OpenStereo key names, so a reference `.pth`
state_dict loads as it is. The JAX package's `.msgpack` files wait.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """A reference checkpoint ({'model_state': sd}, DDP 'module.' prefixes
    allowed), a port checkpoint, or a bare state_dict, on the CPU."""
    if path.endswith(".msgpack"):
        raise NotImplementedError(f"{path}: loading the JAX package's .msgpack files is "
                                  "ROADMAP item 22 (checkpoint tools)")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt.get("model_state", ckpt)
    return {k.removeprefix("module."): v for k, v in state.items()}


def partial_load(model: torch.nn.Module, new: Dict[str, torch.Tensor]) -> Tuple[int, int]:
    """Copy every entry of `new` whose key and shape match one of `model`'s
    (parameters and buffers) into it, in place; keep the rest.

    Returns (loaded, skipped), skipped counting the entries of `new` not
    loaded, as `partial_load` (`pretrained.py:34`) reports.
    """
    current = model.state_dict()
    loaded = 0
    with torch.no_grad():
        for k, v in new.items():
            if k in current and tuple(v.shape) == tuple(current[k].shape):
                current[k].copy_(v)
                loaded += 1
    return loaded, len(new) - loaded
