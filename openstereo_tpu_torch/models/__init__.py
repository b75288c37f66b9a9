"""Model registry and `build_model` (counterpart of `openstereo_tpu/models/__init__.py:32`).

Only LightStereo is ported; the other names of the JAX zoo raise
NotImplementedError naming the ROADMAP item that brings them.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn as nn

from ..config import Config, get_valid_kwargs
from ..device import resolve_device
from .layers import set_kernels  # noqa: F401
from .lightstereo import LightStereo

MODELS = {"LightStereo": LightStereo}

# JAX-zoo names still to be ported → the ROADMAP item (queue 1) that ports them
NOT_PORTED = {
    "PSMNet": "Slice C, item 10",
    "GwcNet": "Slice D, item 11", "CoExNet": "Slice D, item 11",
    "MSNet2D": "Slice D, item 11", "MSNet3D": "Slice D, item 11",
    "CasPSMNet": "Slice D, item 12", "CasGwcNet": "Slice D, item 12",
    "CFNet": "Slice D, item 12", "FADNet": "Slice D, item 12",
    "IGEV": "Slice E, item 14", "IGEVRT": "Slice E, item 14",
    "StereoBase": "Slice E, item 14", "IGEVPP": "Slice E, item 14",
    "FoundationStereo": "Slice E, item 15", "FastFoundationStereo": "Slice E, item 15",
    "MonSter": "Slice E, item 15",
    "STTR": "Slice F, item 16", "AANet": "Slice F, item 17", "NMRF": "Slice F, item 18",
    "IINet": "Slice F, item 19",
}


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights, drawn from `generator` in module order: convs
    uniform ±1/sqrt(fan_in) (PyTorch's default bound), BatchNorm affine and
    running statistics near identity but not equal to it, so a folded BN is
    exercised."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                bound = m.weight[0].numel() ** -0.5
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=generator)
                m.bias.uniform_(-0.1, 0.1, generator=generator)
                m.running_mean.uniform_(-0.1, 0.1, generator=generator)
                m.running_var.uniform_(0.5, 1.5, generator=generator)
                m.num_batches_tracked.zero_()
    return model


def build_model(model_cfg: Config, dtype: torch.dtype = torch.float32,
                device: Optional[Union[str, torch.device]] = None, seed: int = 0) -> nn.Module:
    """Instantiate a MODEL config section in eval mode on `device` (default:
    the CUDA card; the CPU only when asked), with random weights from `seed`.

    UPPER_CASE YAML keys map onto lower_case constructor arguments; unknown
    keys are dropped, as in the JAX package.
    """
    device = resolve_device(device)
    name = model_cfg["NAME"]
    if name in NOT_PORTED:
        raise NotImplementedError(f"{name} is not ported yet: ROADMAP queue 1, {NOT_PORTED[name]}")
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; available: {sorted(MODELS)}")
    cls = MODELS[name]
    kwargs = {k: tuple(v) if isinstance(v, list) else v
              for k, v in get_valid_kwargs(cls.__init__, model_cfg, ignore=["dtype"]).items()}
    with torch.device("meta"):
        model = cls(dtype=dtype, **kwargs)
    model.to_empty(device="cpu")
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
