"""Shared building blocks, NCHW (counterpart of `openstereo_tpu/models/layers.py`).

Conventions, following flax's `dtype=` policy in the JAX package:
- parameters and BatchNorm statistics are stored f32; a conv runs in its
  input's dtype (bf16 on the main path) with its weight cast to that dtype,
  and the cast is cached per weight version;
- softmax/regression heads run in `head_dtype` (at least f32);
- BatchNorm in eval uses its running statistics; in training it follows
  flax's `nn.BatchNorm` (`batch_norm_train`); a BatchNorm module left in
  eval mode inside a training model is FREEZE_BN;
- module attribute names follow the reference OpenStereo state_dict keys
  that `openstereo_tpu/utils/torch_convert.py` reads (`block.0`, `pwconv.1`).

`ConvBlock`, `DeconvBlock` and `convbn` take `ndim=3` for the cost-volume
family (NCDHW, nn.Conv3d / nn.ConvTranspose3d / nn.BatchNorm3d). The JAX
package's 3D-conv lowering pins (`layers.py:31-104`) only choose an XLA
lowering and have no counterpart here.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager, nullcontext
from functools import lru_cache
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.fused_mbconv import fold_mbconv, fused_mbconv


def head_dtype(dtype: torch.dtype) -> torch.dtype:
    """At least f32 for softmax/regression heads (`layers.py:107-111`)."""
    return torch.promote_types(torch.float32, dtype)


def relu6(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(0.0, 6.0)


@lru_cache(maxsize=None)
def _in_dtype(value: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(value, dtype=dtype))


def leaky_relu(negative_slope: float = 0.01) -> Callable:
    """x where x >= 0, else slope·x with the slope rounded to x's dtype first,
    as JAX's weakly typed `negative_slope * x` is (`jax.nn.leaky_relu`): in
    bf16 the slope 0.2 is 0.2001953125, and the product of two bf16 values,
    exact in f32, is rounded once."""
    def act(x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(x, negative_slope=_in_dtype(negative_slope, x.dtype))

    return act


def _split(out, part: slice):
    if isinstance(out, torch.Tensor):
        return out[part]
    if isinstance(out, dict):
        return {k: _split(t, part) for k, t in out.items()}
    return type(out)(_split(t, part) for t in out)


def siamese(fn: Callable, left: torch.Tensor, right: torch.Tensor):
    """Run a weight-shared tower over a stereo pair as one 2B batch and split
    each output back into (left, right) (`layers.py:118-139`). `fn` returns
    a tensor or lists, tuples and dicts of them, nested as a pytree."""
    b = left.shape[0]
    out = fn(torch.cat([left, right], dim=0))
    return _split(out, slice(None, b)), _split(out, slice(b, None))


def compute_weight(p: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    """`p` cast to the compute dtype. Without autograd the cast is cached on
    the parameter, keyed by its storage and version counter, so an in-place
    update or `load_state_dict` invalidates it."""
    if p is None or p.dtype == dtype:
        return p
    if torch.is_grad_enabled():
        return p.to(dtype)
    key = (p.device, p.data_ptr(), p._version, dtype)
    cached = getattr(p, "_cast_cache", None)
    if cached is None or cached[0] != key:
        cached = (key, p.detach().to(dtype))
        p._cast_cache = cached
    return cached[1]


CONVS = {nn.Conv2d: F.conv2d, nn.Conv3d: F.conv3d}
DECONVS = {nn.ConvTranspose2d: F.conv_transpose2d, nn.ConvTranspose3d: F.conv_transpose3d}


def run_conv(x: torch.Tensor, conv: nn.Module) -> torch.Tensor:
    """Apply an nn.Conv2d/3d or nn.ConvTranspose2d/3d in x's dtype.

    Below f32 a bias is added after the conv's result is rounded, as flax's
    `nn.Conv` adds it (two roundings; a conv with its bias fused rounds once)."""
    w, b = compute_weight(conv.weight, x.dtype), compute_weight(conv.bias, x.dtype)
    split = b is not None and x.dtype in (torch.bfloat16, torch.float16)
    fused = None if split else b
    if type(conv) in DECONVS:
        y = DECONVS[type(conv)](x, w, fused, conv.stride, conv.padding, conv.output_padding,
                                conv.groups, conv.dilation)
    else:
        y = CONVS[type(conv)](x, w, fused, conv.stride, conv.padding, conv.dilation, conv.groups)
    return y + b.reshape((-1,) + (1,) * (y.dim() - 2)) if split else y


def linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """An nn.Linear (or a 1×1 conv, as a dense layer) in x's dtype, as flax's
    `nn.Dense(dtype=)` computes it: below f32 the bias is added after the
    product is rounded (as `run_conv`)."""
    w, b = compute_weight(lin.weight, x.dtype).flatten(1), compute_weight(lin.bias, x.dtype)
    split = b is not None and x.dtype in (torch.bfloat16, torch.float16)
    y = F.linear(x, w, None if split else b)
    return y + b if split else y


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU as `jax.nn.gelu(approximate=False)` writes it, x·erfc(−x·√½)/2,
    each op rounded to x's dtype (√½ too): in bf16 the rounded erfc argument
    moves the result by up to ~250 units where it is small, against a GELU
    computed in f32 and rounded once."""
    return x * (torch.special.erfc(-x * _in_dtype(0.5 ** 0.5, x.dtype)) / 2)


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm, dim: int = -1) -> torch.Tensor:
    """flax's `nn.LayerNorm` over axis `dim` (the channels of NCHW with dim=1):
    statistics in at least f32 with flax's fast variance E[x²] − E[x]²
    (clipped at 0), y = (x − µ)·(γ·rsqrt(σ² + eps)) + β in that precision,
    then x's dtype (flax 0.12's `_compute_stats` and `_normalize`)."""
    acc = head_dtype(x.dtype)
    xf = x.to(acc)
    mean = xf.mean(dim, keepdim=True)
    var = ((xf * xf).mean(dim, keepdim=True) - mean * mean).clamp(min=0.0)
    shape = [1] * x.dim()
    shape[dim] = -1
    mul = torch.rsqrt(var + norm.eps) * norm.weight.to(acc).reshape(shape)
    return ((xf - mean) * mul + norm.bias.to(acc).reshape(shape)).to(x.dtype)


_BN_STATE = threading.local()


@contextmanager
def running_stats_frozen():
    """Within it (in this thread), `batch_norm_train` normalises with the batch
    statistics but leaves the running statistics as they are."""
    before = getattr(_BN_STATE, "frozen", False)
    _BN_STATE.frozen = True
    try:
        yield
    finally:
        _BN_STATE.frozen = before


def remat(fn: Callable, *args):
    """`fn(*args)` with its activations recomputed in the backward instead of
    kept (`torch.utils.checkpoint`, non-reentrant): the port's `nn.remat` /
    `jax.checkpoint` (MODEL.REMAT). Flax's remat is functional and updates
    BatchNorm's running statistics once; here the recomputation runs under
    `running_stats_frozen`, so they are updated once too, by the forward.
    The recomputation runs the same operations on the same inputs, so
    gradients are those of `fn` without it."""
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (nullcontext(), running_stats_frozen()))


def batch_norm_train(x: torch.Tensor, norm: nn.Module) -> torch.Tensor:
    """Training BatchNorm as flax's `nn.BatchNorm(momentum=0.9)` computes it
    (`layers.py:276-282` with flax 0.12's `_compute_stats` and `_normalize`):

    - batch statistics in at least f32 (also for a bf16 x), the variance as
      E[x²] − E[x]² clipped at 0 (flax's default `use_fast_variance`);
    - y = (x − µ) · (γ · rsqrt(σ² + eps)) + β in that precision, then x's dtype;
    - the running statistics, as buffers in place, with flax's momentum 0.9
      (torch's `momentum` 0.1) and the *biased* batch variance, except under
      `running_stats_frozen` (a `remat` recomputation). Torch's own
      `F.batch_norm(training=True)` would update with the unbiased one, so it
      only ever runs with running statistics here.
    """
    acc = head_dtype(x.dtype)
    xf = x.to(acc)
    dims = [0] + list(range(2, x.dim()))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mean = xf.mean(dims)
    var = ((xf * xf).mean(dims) - mean * mean).clamp(min=0.0)
    if not getattr(_BN_STATE, "frozen", False):
        _update_running_stats(norm, mean, var)
    mul = torch.rsqrt(var + norm.eps) * norm.weight.to(acc)
    y = (xf - mean.reshape(shape)) * mul.reshape(shape) + norm.bias.to(acc).reshape(shape)
    return y.to(x.dtype)


def _update_running_stats(norm: nn.Module, mean: torch.Tensor, var: torch.Tensor) -> None:
    with torch.no_grad():
        m = norm.momentum
        norm.running_mean.mul_(1.0 - m).add_(mean.detach().to(norm.running_mean.dtype), alpha=m)
        norm.running_var.mul_(1.0 - m).add_(var.detach().to(norm.running_var.dtype), alpha=m)
        norm.num_batches_tracked.add_(1)


def apply_norm(x: torch.Tensor, norm: nn.Module) -> torch.Tensor:
    """BatchNorm (2d or 3d): in training `batch_norm_train`, else its running
    statistics (f32 statistics on an x of any dtype; gradients still reach
    its scale and bias). InstanceNorm (2d, or 3d over D, H and W per
    channel, as flax's `GroupNorm(group_size=1)` on NDHWC): non-affine, eps
    1e-5, statistics in at least f32, the same in both modes
    (`layers.py:266-291`)."""
    if isinstance(norm, (nn.BatchNorm2d, nn.BatchNorm3d)):
        if norm.training:
            return batch_norm_train(x, norm)
        return F.batch_norm(x, norm.running_mean, norm.running_var, norm.weight, norm.bias,
                            False, 0.0, norm.eps)
    if isinstance(norm, (nn.InstanceNorm2d, nn.InstanceNorm3d)):
        return F.instance_norm(x.to(head_dtype(x.dtype)), eps=norm.eps).to(x.dtype)
    raise ValueError(f"unsupported norm {type(norm).__name__}")


def freeze_bn(model: nn.Module) -> nn.Module:
    """FREEZE_BN (`runtime/trainer.py:211-222`): every BatchNorm of a model in
    training uses its running statistics and leaves them as they are; its
    scale and bias still get gradients."""
    for m in model.modules():
        if isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
            m.eval()
    return model


NORMS = (nn.BatchNorm2d, nn.BatchNorm3d, nn.InstanceNorm2d, nn.InstanceNorm3d)


def run_seq(x: torch.Tensor, seq: nn.Sequential) -> torch.Tensor:
    """Walk of a reference-style Sequential: each conv in x's dtype, norms by
    `apply_norm`, ReLU and ReLU6, nested Sequentials; any other module (a
    block of the port) by its own forward."""
    for m in seq:
        if isinstance(m, nn.Sequential):
            x = run_seq(x, m)
        elif isinstance(m, nn.ReLU):
            x = F.relu(x)
        elif isinstance(m, nn.ReLU6):
            x = relu6(x)
        elif type(m) in CONVS or type(m) in DECONVS:
            x = run_conv(x, m)
        elif isinstance(m, NORMS):
            x = apply_norm(x, m)
        else:
            x = m(x)
    return x


def _norm(norm: Optional[str], ch: int, ndim: int = 2):
    if norm is None:
        return []
    if norm == "batch":
        return [(nn.BatchNorm2d if ndim == 2 else nn.BatchNorm3d)(ch)]
    if norm == "instance":
        return [(nn.InstanceNorm2d if ndim == 2 else nn.InstanceNorm3d)(ch)]
    raise ValueError(f"unknown norm {norm!r} for ndim {ndim}")


def ntuple(v, n: int) -> tuple:
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


def conv_norm(in_ch: int, out_ch: int, kernel_size=3, stride=1, padding=None, dilation=1,
              groups: int = 1, bias: bool = False, norm: Optional[str] = None,
              ndim: int = 2) -> list:
    """[conv, norm?]: the conv of `ConvBlock` (`layers.py:150-211`). Kernel,
    stride, padding and dilation are an int or one value per axis; padding
    None is torch's symmetric d·(k-1)/2 per axis (flax ConvBlock's "SAME" in
    the JAX package), else explicit, as MSNet2D's compressor gives it
    (`msnet.py:213-216`)."""
    ks, dil = ntuple(kernel_size, ndim), ntuple(dilation, ndim)
    if padding is None:
        padding = tuple(d * (k - 1) // 2 for k, d in zip(ks, dil))
    conv = (nn.Conv2d if ndim == 2 else nn.Conv3d)(
        in_ch, out_ch, ks, stride, padding=padding, dilation=dil, groups=groups, bias=bias)
    return [conv, *_norm(norm, out_ch, ndim)]


def convbn(in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1, dilation: int = 1,
           ndim: int = 2) -> nn.Sequential:
    """The reference's bias-free conv + BatchNorm, Sequential(conv, bn), with
    torch's symmetric padding d·(k-1)/2."""
    return nn.Sequential(*conv_norm(in_ch, out_ch, kernel_size, stride, dilation=dilation,
                                    norm="batch", ndim=ndim))


def deconv_bn(in_ch: int, out_ch: int, kernel_size: int = 4, norm: Optional[str] = None,
              ndim: int = 2):
    """The reference's two spatial-doubling deconvs (`layers.py:214-263`):
    k4 s2 p1, and k3 s2 p1 with output_padding 1; bias-free."""
    if kernel_size not in (3, 4):
        raise ValueError(f"deconv kernel_size must be 3 or 4, got {kernel_size}")
    deconv = (nn.ConvTranspose2d if ndim == 2 else nn.ConvTranspose3d)(
        in_ch, out_ch, kernel_size, stride=2, padding=1,
        output_padding=1 if kernel_size == 3 else 0, bias=False)
    return nn.Sequential(deconv, *_norm(norm, out_ch, ndim))


class ConvBlock(nn.Module):
    """Conv + optional norm + optional activation (`layers.py:150-211`), 2D
    (NCHW) or, with ndim=3, 3D (NCDHW).

    Kernel, stride and dilation as `conv_norm` takes them (an int or one per
    axis), with torch's symmetric padding d·(k-1)/2; pad_mode "replicate"
    edge-pads first and convolves unpadded. Keys: block.0 (conv), block.1
    (norm).
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size=3, stride=1, dilation=1,
                 groups: int = 1, bias: bool = False, norm: Optional[str] = None,
                 act: Optional[Callable] = None, pad_mode: str = "zeros", ndim: int = 2):
        super().__init__()
        if pad_mode not in ("zeros", "replicate"):
            raise ValueError(f"unknown pad_mode {pad_mode!r}")
        conv, *norm_ = conv_norm(in_ch, out_ch, kernel_size, stride, None, dilation, groups,
                                 bias, norm, ndim)
        self.pad_mode = pad_mode
        if pad_mode == "replicate":
            # edge-pad first, then convolve unpadded
            self.pad = conv.padding
            conv.padding = (0,) * ndim
        self.block = nn.Sequential(conv, *norm_)
        self.act = act

    def forward(self, x):
        if self.pad_mode == "replicate" and any(self.pad):
            x = F.pad(x, [p for p in reversed(self.pad) for _ in (0, 1)], mode="replicate")
        x = run_seq(x, self.block)
        return self.act(x) if self.act is not None else x


class DeconvBlock(nn.Module):
    """Transposed conv (k4 s2 p1 or k3 s2 p1 op1) + optional norm + act, 2D or,
    with ndim=3, 3D. Keys: block.0 (deconv), block.1 (norm)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 4,
                 norm: Optional[str] = None, act: Optional[Callable] = None, ndim: int = 2):
        super().__init__()
        self.block = deconv_bn(in_ch, out_ch, kernel_size, norm, ndim)
        self.act = act

    def forward(self, x):
        x = run_seq(x, self.block)
        return self.act(x) if self.act is not None else x


class FusableMBConv(nn.Module):
    """Base of the inverted-residual blocks that the fused MBConv kernel runs.

    Subclasses define `_mbconv_parts()` → (pw conv, bn, dw conv, bn, pwl
    conv, bn) and `fusable` (stride 1, dilation 1, with an expand). In eval
    with `use_kernels` on, forward goes to `ops.fused_mbconv` with the
    BatchNorms folded once per weight version; otherwise it runs the eager
    conv/BN chain.
    """

    use_kernels = True
    fusable = False
    use_res = False

    def _mbconv_parts(self):
        raise NotImplementedError

    def folded(self, dtype: torch.dtype):
        parts = self._mbconv_parts()
        tensors = [t for m in parts for t in
                   ([m] if isinstance(m, torch.Tensor) else list(m.parameters()) + list(m.buffers()))]
        key = (dtype,) + tuple((t.device, t.data_ptr(), t._version) for t in tensors)
        cached = getattr(self, "_fold_cache", None)
        if cached is None or cached[0] != key:
            cached = (key, fold_mbconv(*parts, dtype=dtype))
            self._fold_cache = cached
        return cached[1]

    def forward_fused(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """The fused kernel in eval; None in training (the kernel folds BN,
        which training cannot), so the eager chain runs there."""
        if not (self.fusable and self.use_kernels and not self.training):
            return None
        return fused_mbconv(x.contiguous(), *self.folded(x.dtype), residual=self.use_res)


class MobileV2Residual(FusableMBConv):
    """Inverted residual pw-expand → dw3×3 → pw-linear, all BN
    (`layers.py:350-373`). Keys: pwconv, dwconv, pwliner (each .0 conv, .1 BN)."""

    def __init__(self, inp: int, oup: int, stride: int = 1, expanse_ratio: float = 4,
                 dilation: int = 1):
        super().__init__()
        hidden = int(inp * expanse_ratio)
        self.use_res = stride == 1 and inp == oup
        self.fusable = stride == 1 and dilation == 1
        self.pwconv = nn.Sequential(nn.Conv2d(inp, hidden, 1, bias=False), nn.BatchNorm2d(hidden))
        self.dwconv = nn.Sequential(
            nn.Conv2d(hidden, hidden, 3, stride, padding=dilation, dilation=dilation,
                      groups=hidden, bias=False),
            nn.BatchNorm2d(hidden))
        self.pwliner = nn.Sequential(nn.Conv2d(hidden, oup, 1, bias=False), nn.BatchNorm2d(oup))

    def _mbconv_parts(self):
        return (self.pwconv[0].weight, self.pwconv[1], self.dwconv[0].weight, self.dwconv[1],
                self.pwliner[0].weight, self.pwliner[1])

    def forward(self, x):
        y = self.forward_fused(x)
        if y is not None:
            return y
        y = relu6(run_seq(x, self.pwconv))
        y = relu6(run_seq(y, self.dwconv))
        y = run_seq(y, self.pwliner)
        return x + y if self.use_res else y


def mbconv_seq(inp: int, oup: int, stride: int, hidden: int, ndim: int) -> nn.Sequential:
    """MSNet's reference inverted residual body (`msnet/submodule.py`), one
    Sequential: pw conv, BN, ReLU6, dw 3×3 conv, BN, ReLU6, pwl conv, BN."""
    conv, bn = (nn.Conv2d, nn.BatchNorm2d) if ndim == 2 else (nn.Conv3d, nn.BatchNorm3d)
    return nn.Sequential(
        conv(inp, hidden, 1, bias=False), bn(hidden), nn.ReLU6(),
        conv(hidden, hidden, 3, stride, 1, groups=hidden, bias=False), bn(hidden), nn.ReLU6(),
        conv(hidden, oup, 1, bias=False), bn(oup))


class MobileV2ResidualSeq(FusableMBConv):
    """`MobileV2Residual` (`layers.py:350-373`) with MSNet's reference keys:
    conv.{0,1} pw conv/BN, conv.{3,4} dw, conv.{6,7} pw-linear
    (`torch_convert.py:_mv2`). Stride-1 blocks run the fused MBConv kernel
    in eval, as LightStereo's do."""

    def __init__(self, inp: int, oup: int, stride: int = 1, expanse_ratio: float = 4):
        super().__init__()
        self.use_res = stride == 1 and inp == oup
        self.fusable = stride == 1
        self.conv = mbconv_seq(inp, oup, stride, int(inp * expanse_ratio), 2)

    def _mbconv_parts(self):
        c = self.conv
        return c[0].weight, c[1], c[3].weight, c[4], c[6].weight, c[7]

    def forward(self, x):
        y = self.forward_fused(x)
        if y is not None:
            return y
        y = run_seq(x, self.conv)
        return x + y if self.use_res else y


class MobileV2Residual3D(nn.Module):
    """3D inverted block, NCDHW (`layers.py:294-319`), keys as
    `MobileV2ResidualSeq`. Like the reference (and the JAX package), it never
    takes its residual: the reference tests `stride == (1, 1, 1)` against the
    int every caller passes."""

    def __init__(self, inp: int, oup: int, stride: int = 1, expanse_ratio: float = 2):
        super().__init__()
        self.conv = mbconv_seq(inp, oup, stride, round(inp * expanse_ratio), 3)

    def forward(self, x):
        return run_seq(x, self.conv)


class MobileV1Residual(nn.Module):
    """Depthwise-separable residual (`layers.py:322-347`): conv1 = (dw 3×3
    conv, BN, ReLU6, pw conv, BN, ReLU6), conv2 the same without the last
    ReLU6, both dw convs dilated; plus x, through the 1×1 `downsample`
    convbn where the stride or the width changes. Keys as
    `torch_convert.py:_mv1`."""

    def __init__(self, inp: int, oup: int, stride: int = 1, dilation: int = 1):
        super().__init__()

        def dws(cin, s, second_relu):
            return nn.Sequential(
                nn.Conv2d(cin, cin, 3, s, dilation, dilation, groups=cin, bias=False),
                nn.BatchNorm2d(cin), nn.ReLU6(),
                nn.Conv2d(cin, oup, 1, bias=False), nn.BatchNorm2d(oup),
                *([nn.ReLU6()] if second_relu else []))

        self.conv1 = dws(inp, stride, True)
        self.conv2 = dws(oup, 1, False)
        self.downsample = convbn(inp, oup, 1, stride) if stride != 1 or inp != oup else None

    def forward(self, x):
        y = run_seq(run_seq(x, self.conv1), self.conv2)
        return y + (x if self.downsample is None else run_seq(x, self.downsample))


def set_kernels(model: nn.Module, enabled: bool) -> nn.Module:
    """Route every kernel-capable module of `model` through its CUDA kernel
    (True) or its eager PyTorch path (False)."""
    for m in model.modules():
        if hasattr(m, "use_kernels"):
            m.use_kernels = enabled
    return model
