"""Seeding (counterpart of `openstereo_tpu/utils/seeds.py:16`)."""

from __future__ import annotations

import random

import numpy as np
import torch


def set_random_seed(seed: int) -> torch.Generator:
    """Seed Python's, numpy's and torch's global generators and return a
    `torch.Generator` seeded the same, for draws that should not depend on
    the global state (the JAX function returns its root key)."""
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
