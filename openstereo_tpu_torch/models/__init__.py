"""Model registry and `build_model` (counterpart of `openstereo_tpu/models/__init__.py:32`).

LightStereo, STTR, GwcNet, PSMNet, CoEx, MSNet3D, MSNet2D, CFNet, FADNet,
CasGwcNet, CasPSMNet, IGEV, IGEV-RT, StereoBase (also under its configs'
name StereoBaseGRU), IGEV++, FoundationStereo, FastFoundationStereo and
MonSter are ported, for inference and for training; the other names
of the JAX zoo raise NotImplementedError naming the ROADMAP item that
brings them.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn as nn

from ..config import Config, get_valid_kwargs
from ..device import resolve_device
from .casnet import CasGwcNet, CasPSMNet
from .cfnet import CFNet
from .backbones.dinov2 import DinoViT, LayerScale
from .backbones.edgenext import XCA, ConvEncoder, SDTAEncoder
from .coex import CoExNet
from .fadnet import FADNet
from .fastfoundationstereo import FastFoundationStereo
from .foundationstereo import FoundationStereo
from .foundationstereo.blocks import EdgeNextConvEncoderPlain
from .gwcnet import GwcNet
from .igev import IGEV
from .igev_rt import IGEVRT
from .igevpp import IGEVPP
from .layers import set_kernels  # noqa: F401
from .lightstereo import LightStereo
from .monster import MonSter
from .msnet import MSNet2D, MSNet3D
from .psmnet import PSMNet
from .stereobase import StereoBase
from .sttr import STTR
from .sttr.blocks import WNConv
from .sttr.sttr import RegressionHead
from .sttr.transformer import MultiheadAttentionRelative

MODELS = {"LightStereo": LightStereo, "STTR": STTR, "GwcNet": GwcNet, "PSMNet": PSMNet,
          "CoExNet": CoExNet, "MSNet3D": MSNet3D, "MSNet2D": MSNet2D, "CFNet": CFNet,
          "FADNet": FADNet, "CasGwcNet": CasGwcNet, "CasPSMNet": CasPSMNet, "IGEV": IGEV,
          "IGEVRT": IGEVRT, "StereoBase": StereoBase, "StereoBaseGRU": StereoBase,
          "IGEVPP": IGEVPP, "FoundationStereo": FoundationStereo,
          "FastFoundationStereo": FastFoundationStereo, "MonSter": MonSter}

# JAX-zoo names still to be ported → the ROADMAP item (queue 1) that ports them
NOT_PORTED = {
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
    `phi` is uniform ±0.5, CFNet's range scalars (γ, β per stage) ±0.1.
    Scales that flax initialises to a constant c (the ViT's and EdgeNeXt's
    LayerScale, XCA's temperature) are uniform in [0.5·c, 1.5·c]; the ViT's
    class token ±0.02 and position table ±0.04 (flax: 0 and N(0, 0.02)).
    Raises if a parameter or buffer is left undrawn.
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
            elif isinstance(m, CFNet):
                for p in (m.gamma_s3, m.beta_s3, m.gamma_s2, m.beta_s2):
                    draw(p, -0.1, 0.1)
            elif isinstance(m, LayerScale):
                draw(m.gamma, 0.5, 1.5)
            elif isinstance(m, (ConvEncoder, EdgeNextConvEncoderPlain)):
                draw(m.gamma, 0.5e-6, 1.5e-6)
            elif isinstance(m, SDTAEncoder):
                draw(m.gamma, 0.5e-6, 1.5e-6)
                draw(m.gamma_xca, 0.5e-6, 1.5e-6)
            elif isinstance(m, XCA):
                draw(m.temperature, 0.5, 1.5)
            elif isinstance(m, DinoViT):
                draw(m.cls_token, -0.02, 0.02)
                draw(m.pos_embed, -0.04, 0.04)
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


def _trunc_normal(t: torch.Tensor, fan: int, scale: float, generator: torch.Generator):
    """flax's variance_scaling(scale, "fan_in", "truncated_normal"): a normal
    truncated at ±2 σ whose variance is scale / fan."""
    std = (scale / fan) ** 0.5 / _TRUNC_STD
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def init_training_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's default initialisers, which the JAX trainer starts from
    (`runtime/trainer.py:186-194`): conv, deconv and linear kernels
    lecun-normal (truncated normal, variance 1/fan_in), zero biases,
    BatchNorm scale 1, bias 0, mean 0, var 1, LayerNorm scale 1, bias 0,
    CFNet's range scalars 0; the ViT's LayerScale 1, class token 0 and
    position table N(0, 0.02), EdgeNeXt's layer scales 1e-6 and XCA's
    temperature 1 (`backbones/dinov2.py`, `backbones/edgenext.py`,
    `foundationstereo/blocks.py:313`). STTR's as its flax modules declare them: each
    third of the packed attention projection (the q, k and v `nn.Dense`)
    lecun-normal over its own fan-in, zero biases; the weight-normed convs'
    directions he-normal (variance 2/fan_in, `blocks.py:184`), gains 1,
    biases 0; the dustbin cost `phi` 0 (`sttr.py:174`). Drawn from
    `generator` in module order. Raises on a parameter left undrawn."""
    drawn = set()

    def fill(t: torch.Tensor, value: float):
        t.fill_(value)
        drawn.add(id(t))

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Conv3d, nn.ConvTranspose3d,
                              nn.Linear)):
                _trunc_normal(m.weight, fan_in(m), 1.0, generator)
                drawn.add(id(m.weight))
                if m.bias is not None:
                    fill(m.bias, 0.0)
            elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d, nn.LayerNorm)):
                fill(m.weight, 1.0)
                fill(m.bias, 0.0)
                if not isinstance(m, nn.LayerNorm):
                    m.reset_running_stats()
                    drawn.update(id(t) for t in m.buffers())
            elif isinstance(m, MultiheadAttentionRelative):
                for third in m.in_proj_weight.chunk(3):
                    _trunc_normal(third, m.embed_dim, 1.0, generator)
                drawn.add(id(m.in_proj_weight))
                fill(m.in_proj_bias, 0.0)
            elif isinstance(m, WNConv):
                _trunc_normal(m.weight_v, m.weight_v[0].numel(), 2.0, generator)
                drawn.add(id(m.weight_v))
                fill(m.weight_g, 1.0)
                fill(m.bias, 0.0)
            elif isinstance(m, RegressionHead):
                fill(m.phi, 0.0)
            elif isinstance(m, CFNet):
                for p in (m.gamma_s3, m.beta_s3, m.gamma_s2, m.beta_s2):
                    fill(p, 0.0)
            elif isinstance(m, LayerScale):
                fill(m.gamma, 1.0)
            elif isinstance(m, (ConvEncoder, EdgeNextConvEncoderPlain)):
                fill(m.gamma, 1e-6)
            elif isinstance(m, SDTAEncoder):
                fill(m.gamma, 1e-6)
                fill(m.gamma_xca, 1e-6)
            elif isinstance(m, XCA):
                fill(m.temperature, 1.0)
            elif isinstance(m, DinoViT):
                fill(m.cls_token, 0.0)
                m.pos_embed.normal_(0.0, 0.02, generator=generator)
                drawn.add(id(m.pos_embed))
    missed = [k for k, t in list(model.named_parameters()) + list(model.named_buffers())
              if id(t) not in drawn]
    if missed:
        raise NotImplementedError(f"no training initialiser for {missed[:8]}")
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
        raise NotImplementedError(f"{name} is not ported yet (ROADMAP.md queue 1, "
                                  f"{NOT_PORTED[name]}); ported: {sorted(MODELS)}")
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
