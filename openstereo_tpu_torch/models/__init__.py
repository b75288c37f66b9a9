"""Model registry and `build_model` (counterpart of `openstereo_tpu/models/__init__.py:32`).

LightStereo, STTR, GwcNet, PSMNet, CoEx, MSNet3D and MSNet2D are ported;
the other names of the JAX zoo raise NotImplementedError naming the ROADMAP
item that brings them.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn as nn

from ..config import Config, get_valid_kwargs
from ..device import resolve_device
from .coex import CoExNet
from .gwcnet import GwcNet
from .layers import set_kernels  # noqa: F401
from .lightstereo import LightStereo
from .msnet import MSNet2D, MSNet3D
from .psmnet import PSMNet
from .sttr import STTR
from .sttr.blocks import WNConv
from .sttr.sttr import RegressionHead
from .sttr.transformer import MultiheadAttentionRelative

MODELS = {"LightStereo": LightStereo, "STTR": STTR, "GwcNet": GwcNet, "PSMNet": PSMNet,
          "CoExNet": CoExNet, "MSNet3D": MSNet3D, "MSNet2D": MSNet2D}

# JAX-zoo names still to be ported → the ROADMAP item (queue 1) that ports them
NOT_PORTED = {
    "CasPSMNet": "Slice D, item 12", "CasGwcNet": "Slice D, item 12",
    "CFNet": "Slice D, item 12", "FADNet": "Slice D, item 12",
    "IGEV": "Slice E, item 14", "IGEVRT": "Slice E, item 14",
    "StereoBase": "Slice E, item 14", "IGEVPP": "Slice E, item 14",
    "FoundationStereo": "Slice E, item 15", "FastFoundationStereo": "Slice E, item 15",
    "MonSter": "Slice E, item 15",
    "AANet": "Slice F, item 17", "NMRF": "Slice F, item 18",
    "IINet": "Slice F, item 19",
}


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights, drawn from `generator` in module order.

    Convs, linear layers, the packed attention projections and weight-normed
    convs' directions are uniform ±1/sqrt(fan_in) (PyTorch's default bound),
    with their biases. BatchNorm affine and running statistics, LayerNorm
    affine and weight-norm gains are near identity but not equal to it, so
    a folded BN or a LayerNorm's affine is exercised. STTR's dustbin cost
    `phi` is uniform ±0.5. Raises if a parameter or buffer is left undrawn.
    """
    drawn = set()

    def draw(t: torch.Tensor, lo: float, hi: float):
        t.uniform_(lo, hi, generator=generator)
        drawn.add(id(t))

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Conv3d, nn.ConvTranspose3d,
                              nn.Linear)):
                bound = m.weight[0].numel() ** -0.5
                draw(m.weight, -bound, bound)
                if m.bias is not None:
                    draw(m.bias, -bound, bound)
            elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
                draw(m.weight, 0.5, 1.5)
                draw(m.bias, -0.1, 0.1)
                draw(m.running_mean, -0.1, 0.1)
                draw(m.running_var, 0.5, 1.5)
                m.num_batches_tracked.zero_()
                drawn.add(id(m.num_batches_tracked))
            elif isinstance(m, nn.LayerNorm):
                draw(m.weight, 0.5, 1.5)
                draw(m.bias, -0.1, 0.1)
            elif isinstance(m, WNConv):
                bound = m.weight_v[0].numel() ** -0.5
                draw(m.weight_v, -bound, bound)
                draw(m.weight_g, 0.3, 0.9)  # the norm of a default-drawn filter is ~0.58
                draw(m.bias, -bound, bound)
            elif isinstance(m, MultiheadAttentionRelative):
                bound = m.embed_dim ** -0.5
                draw(m.in_proj_weight, -bound, bound)
                draw(m.in_proj_bias, -bound, bound)
            elif isinstance(m, RegressionHead):
                draw(m.phi, -0.5, 0.5)
    missed = [k for k, t in list(model.named_parameters()) + list(model.named_buffers())
              if id(t) not in drawn]
    if missed:
        raise RuntimeError(f"init_weights drew no values for {missed[:8]}")
    return model


# flax's lecun_normal: a normal truncated at ±2 σ, σ rescaled so the variance is 1/fan_in
_TRUNC_STD = 0.87962566103423978


def fan_in(m: nn.Module) -> int:
    """The fan-in flax computes for the kernel of the counterpart of `m`: the
    product of its (kh, kw[, kd], in) axes. A torch conv weight is
    [out, in/groups, k...], a transposed conv's [in, out/groups, k...]."""
    w = m.weight
    if isinstance(m, (nn.ConvTranspose2d, nn.ConvTranspose3d)):
        return w.shape[0] * w[0, 0].numel()
    return w[0].numel()


def init_training_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's default initialisers, which the JAX trainer starts from
    (`runtime/trainer.py:186-194`): conv, deconv and linear kernels
    lecun-normal (truncated normal, variance 1/fan_in), zero biases,
    BatchNorm scale 1, bias 0, mean 0, var 1, LayerNorm scale 1, bias 0.
    Drawn from `generator` in module order. Raises on a parameter that flax
    would not initialise this way (STTR's weight-normed convs, attention
    projections and dustbin cost: STTR training is ROADMAP item 8)."""
    drawn = set()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Conv3d, nn.ConvTranspose3d,
                              nn.Linear)):
                std = fan_in(m) ** -0.5 / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                drawn.add(id(m.weight))
                if m.bias is not None:
                    m.bias.zero_()
                    drawn.add(id(m.bias))
            elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d, nn.LayerNorm)):
                for t, v in ((m.weight, 1.0), (m.bias, 0.0)):
                    t.fill_(v)
                    drawn.add(id(t))
                if not isinstance(m, nn.LayerNorm):
                    m.reset_running_stats()
                    drawn.update(id(t) for t in m.buffers())
    missed = [k for k, t in list(model.named_parameters()) + list(model.named_buffers())
              if id(t) not in drawn]
    if missed:
        raise NotImplementedError(
            f"no training initialiser for {missed[:8]}; STTR training is ROADMAP item 8")
    return model


INITS = {"test": init_weights, "train": init_training_weights}


def build_model(model_cfg: Config, dtype: torch.dtype = torch.float32,
                device: Optional[Union[str, torch.device]] = None, seed: int = 0,
                init: str = "test") -> nn.Module:
    """Instantiate a MODEL config section in eval mode on `device` (default:
    the CUDA card; the CPU only when asked), with random weights from `seed`:
    `init` "test" draws every weight and BatchNorm statistic away from
    identity (`init_weights`), "train" is flax's default initialisation
    (`init_training_weights`), which training starts from.

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
    INITS[init](model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
