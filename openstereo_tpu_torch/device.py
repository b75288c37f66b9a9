"""Device resolution: entry points run on the card unless asked for the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` means the CUDA card; the CPU only when the caller names it.

    Raises RuntimeError when no card is present and the caller did not ask
    for the CPU, so a missing GPU never turns into a silent CPU run.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' (CLI: --device cpu) "
                "to run on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device
