"""CFNet, NCHW / NCDHW (counterpart of `openstereo_tpu/models/cfnet/cfnet.py`).

Pyramid features (1/2..1/32, PSP pooling, a top-down decoder, Mish) →
fused group-wise + concat volumes at 1/8, 1/16 and 1/32, combined by
`HourglassUp` and a second hourglass → a disparity and its spread at 1/8 →
a per-pixel search range, re-sampled at 1/4 and then 1/2 with volumes
warped to integer disparity samples (`warped_volumes`), each stage a
confidence hourglass pair and a soft-argmax against its sample grid →
align-corners upsample to [B,H,W]. Eval runs one head per stage; training
adds `classif0`/`classif1` at 1/8 and the `confidence_classif0/mid` heads of
each warped stage, nine heads in all, with the features run once per view.

With `use_kernels` on (the default) the three fused group-wise volumes go
through the CUDA kernel K3 (`ops.gwc_volume`; on a CPU tensor, its plain
version) in eval; off, and in training, through the plain builder. The
warped volumes are gathers in plain PyTorch, as they are jnp in the JAX
package. Every 3D conv runs on cuDNN.

Attribute names follow the reference OpenStereo CFNet state_dict, as
`openstereo_tpu/utils/torch_convert.py:convert_cfnet` reads it. The
reference's `combine1.combine3` and `combine1.redir3`, built and never run
(`torch_convert.py:1250`), are left out (`REFERENCE_ONLY_KEYS`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import (build_concat_volume, build_gwc_volume, disparity_regression, gwc_volume,
                    resize_bilinear, resize_linear_align_corners, sample_along_w)
from ..gwcnet.gwcnet import GwcHourglass, convbn_act_3d
from ..layers import convbn, deconv_bn, head_dtype, run_conv, run_seq, siamese
from ..losses import weighted_heads_loss
from ..psmnet.psmnet import ResBlock


def mish(x: torch.Tensor) -> torch.Tensor:
    """x·tanh(softplus(x)) in x's dtype, one rounding per op as the JAX
    program `x * jnp.tanh(jax.nn.softplus(x))` rounds (`cfnet.py:41-42`).
    Its softplus is `jnp.logaddexp(x, 0)`, max(x, 0) + log1p(exp(−|x|)),
    and in bf16 XLA:CPU rounds each of those ops, also under jit (ROADMAP
    3k); `F.softplus` and `F.mish` would round once."""
    return x * torch.tanh(x.clamp(min=0) + torch.log1p(torch.exp(-x.abs())))


class Mish(nn.Module):
    def forward(self, x):
        return mish(x)


def _act(replace_mish: bool) -> nn.Module:
    """REPLACE_MISH (`cfnet.py:218-220`): ReLU in place of every Mish."""
    return nn.ReLU() if replace_mish else Mish()


def mish_res_block(in_ch: int, out_ch: int, stride: int, act: nn.Module) -> nn.Sequential:
    """`MishResBlock` (`cfnet.py:45-66`): PSMNet's residual block with its
    activation a Mish, as the reference's one-block `layerN` Sequential."""
    return nn.Sequential(ResBlock(in_ch, out_ch, stride, nested=True, act=act))


def cbr(in_ch: int, out_ch: int, kernel_size: int, stride: int, act: nn.Module) -> nn.Sequential:
    """Sequential(convbn, act): a flax ConvBlock with BatchNorm and activation."""
    return nn.Sequential(convbn(in_ch, out_ch, kernel_size, stride), act)


class _PSPPath(nn.Module):
    def __init__(self, ch: int, act: nn.Module):
        super().__init__()
        self.cbr_unit = nn.Sequential(*convbn(ch, ch, 1), act)  # conv, bn, act


class _PyramidPooling(nn.Module):
    def __init__(self, ch: int, act: nn.Module):
        super().__init__()
        self.path_module_list = nn.ModuleList(_PSPPath(ch, act) for _ in range(4))


class CFFeatures(nn.Module):
    """Pyramid encoder + PSP + decoder → per-scale group-wise (`gw2`..`gw6`)
    and concat (`concat_feature2`..`6`) descriptors (`cfnet.py:69-147`)."""

    def __init__(self, concat_channels: int = 12, act: nn.Module = None):
        super().__init__()
        act = act or Mish()
        self.act = act
        self.firstconv = nn.Sequential(convbn(3, 32, 3, 2), act, convbn(32, 32), act,
                                       convbn(32, 32), act)
        for i, (cin, cout, s) in zip((2, 3, 4, 5, 6), ((32, 64, 1), (64, 128, 2), (128, 192, 2),
                                                       (192, 256, 2), (256, 512, 2))):
            setattr(self, f"layer{i}", mish_res_block(cin, cout, s, act))
        self.pyramid_pooling = _PyramidPooling(512, act)
        for i, (cin, cout, skip) in zip((6, 5, 4, 3), ((512, 256, 256), (256, 192, 192),
                                                       (192, 128, 128), (128, 64, 64))):
            setattr(self, f"upconv{i}",
                    nn.Sequential(nn.Upsample(scale_factor=2), convbn(cin, cout), act))
            setattr(self, f"iconv{i - 1}", cbr(skip + cout, cout, 3, 1, act))
        cc = concat_channels
        heads = {2: (64, 80, 80, 32, cc // 2), 3: (128, 160, 160, 128, cc),
                 4: (192, 160, 160, 128, cc), 5: (256, 320, 320, 128, cc),
                 6: (512, 320, 320, 128, cc)}
        for n, (cin, gmid, gout, cmid, cout) in heads.items():
            setattr(self, f"gw{n}", nn.Sequential(convbn(cin, gmid), act,
                                                  nn.Conv2d(gmid, gout, 1, bias=False)))
            setattr(self, f"concat{n}", nn.Sequential(convbn(cin, cmid), act,
                                                      nn.Conv2d(cmid, cout, 1, bias=False)))

    def psp(self, l6: torch.Tensor) -> torch.Tensor:
        """Sum-fused PSP pooling over windows from `linspace(2, min(h6, w6), 4)`
        (`cfnet.py:90-97`): each pooled branch conv-BN-act'd, bilinearly
        upsampled back (half-pixel, as `jax.image.resize`), added at 0.25;
        then act(sum / 2)."""
        h6, w6 = l6.shape[-2:]
        pp = l6
        for i, pool_size in enumerate(np.linspace(2, min(h6, w6), 4, dtype=int)[::-1]):
            kh, kw = max(h6 // int(pool_size), 1), max(w6 // int(pool_size), 1)
            p = F.avg_pool2d(l6, (kh, kw), (kh, kw))
            p = run_seq(p, self.pyramid_pooling.path_module_list[i].cbr_unit)
            pp = pp + 0.25 * resize_bilinear(p, (h6, w6))
        return self.act(pp / 2.0)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        y = run_seq(x, self.firstconv)
        l2 = self.layer2(y)
        l3 = self.layer3(l2)
        l4 = self.layer4(l3)
        l5 = self.layer5(l4)
        l6 = self.psp(self.layer6(l5))
        d5 = run_seq(torch.cat([l5, run_seq(l6, self.upconv6)], 1), self.iconv5)
        d4 = run_seq(torch.cat([l4, run_seq(d5, self.upconv5)], 1), self.iconv4)
        d3 = run_seq(torch.cat([l3, run_seq(d4, self.upconv4)], 1), self.iconv3)
        d2 = run_seq(torch.cat([l2, run_seq(d3, self.upconv3)], 1), self.iconv2)
        out = {}
        for n, v in ((2, d2), (3, d3), (4, d4), (5, d5), (6, l6)):
            out[f"gw{n}"] = run_seq(v, getattr(self, f"gw{n}"))
            out[f"concat_feature{n}"] = run_seq(v, getattr(self, f"concat{n}"))
        return out


class HourglassUp(nn.Module):
    """Hourglass with the 1/16 and 1/32 volumes injected after each
    stride-2 conv (`cfnet.py:150-190`); `conv1`/`conv3` are bare convs."""

    def __init__(self, c: int, act: nn.Module):
        super().__init__()
        self.act = act
        self.conv1 = nn.Conv3d(c, 2 * c, 3, 2, 1, bias=False)
        self.combine1 = convbn_act_3d(4 * c, 2 * c, 1, act)
        self.conv2 = convbn_act_3d(2 * c, 2 * c, 1, act)
        self.conv3 = nn.Conv3d(2 * c, 4 * c, 3, 2, 1, bias=False)
        self.combine2 = convbn_act_3d(6 * c, 4 * c, 1, act)
        self.conv4 = convbn_act_3d(4 * c, 4 * c, 1, act)
        self.conv8 = deconv_bn(4 * c, 2 * c, 3, "batch", ndim=3)
        self.conv9 = deconv_bn(2 * c, c, 3, "batch", ndim=3)
        self.redir1 = convbn(c, c, 1, ndim=3)
        self.redir2 = convbn(2 * c, 2 * c, 1, ndim=3)

    def forward(self, x, feat4, feat5):
        conv1 = run_seq(torch.cat([run_conv(x, self.conv1), feat4], 1), self.combine1)
        conv2 = run_seq(conv1, self.conv2)
        conv3 = run_seq(torch.cat([run_conv(conv2, self.conv3), feat5], 1), self.combine2)
        conv4 = run_seq(conv3, self.conv4)
        conv8 = self.act(run_seq(conv4, self.conv8) + run_seq(conv2, self.redir2))
        return self.act(run_seq(conv8, self.conv9) + run_seq(x, self.redir1))


def _up_full(pred: torch.Tensor, scale: float, size) -> torch.Tensor:
    """[B,h,w] ×scale, resized with aligned corners to [B,H,W] (`cfnet.py:332`)."""
    return resize_linear_align_corners((pred * scale)[:, None], size)[:, 0]


def warped_volumes(gw_l, gw_r, cat_l, cat_r, samples, num_groups: int) -> torch.Tensor:
    """[B,G + 2·Cc + 1, D, H, W]: the group-wise correlation of the left
    features with the right ones warped to each sample, the left and warped
    right concat features, and the sample plane (`cfnet.py:193-206`).
    The group mean accumulates in f32, as `jnp.mean` of bf16 does; the
    concatenation promotes to the samples' dtype, as `jnp.concatenate` does."""
    b, c, h, w = gw_l.shape
    d = samples.shape[1]
    pos = torch.arange(w, dtype=samples.dtype, device=samples.device) - samples
    gw_r_w = sample_along_w(gw_r, pos)
    cat_r_w = sample_along_w(cat_r, pos)
    prod = (gw_l[:, :, None] * gw_r_w).reshape(b, num_groups, c // num_groups, d, h, w)
    gwc = prod.mean(dim=2)
    cat_l_e = cat_l[:, :, None].expand(b, cat_l.shape[1], d, h, w)
    return torch.cat([gwc, cat_l_e, cat_r_w, samples[:, None]], dim=1)


class CFNet(nn.Module):
    """forward(data) → {'disp_pred': [B,H,W]}, in training also
    {'disp_preds': the nine heads' [B,H,W]} (`cfnet.py:351-362`).

    data['left'] / data['right']: [B,3,H,W] normalized images, H, W and
    max_disp multiples of 32 (the 1/8 volume halves twice). `dtype` is the
    compute dtype (bf16 on the main path); parameters stay f32 and the
    softmax heads, the search ranges and the sample grids run in at least
    f32.
    """

    use_kernels = True
    head_weights = (0.25, 0.35, 0.5, 0.5, 0.7, 1.0, 1.0, 1.4, 2.0)  # `cfnet.py:221`
    REFERENCE_ONLY_KEYS = ("combine1.combine3.", "combine1.redir3.")

    def __init__(self, max_disp: int = 192, num_groups: int = 40, concat_channels: int = 12,
                 sample_count_s3: int = 14, sample_count_s2: int = 10,
                 replace_mish: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.max_disp, self.num_groups = max_disp, num_groups
        self.sample_count_s3, self.sample_count_s2 = sample_count_s3, sample_count_s2
        self.dtype = dtype
        act = _act(replace_mish)
        cc = concat_channels
        self.feature_extraction = CFFeatures(cc, act)
        vol_ch = num_groups + 2 * cc
        for suf, f in (("", 32), ("_5", 64), ("_6", 64)):
            setattr(self, f"dres0{suf}", nn.Sequential(convbn(vol_ch, f, ndim=3), act,
                                                       convbn(f, f, ndim=3), act))
            setattr(self, f"dres1{suf}", nn.Sequential(convbn(f, f, ndim=3), act,
                                                       convbn(f, f, ndim=3)))
        self.combine1 = HourglassUp(32, act)
        self.dres3 = GwcHourglass(32, act)
        for s, f, ch in (("s3", 32, num_groups + 2 * cc + 1),
                         ("s2", 16, num_groups // 2 + cc + 1)):
            setattr(self, f"confidence0_{s}", nn.Sequential(convbn(ch, f, ndim=3), act,
                                                            convbn(f, f, ndim=3), act))
            setattr(self, f"confidence1_{s}", nn.Sequential(convbn(f, f, ndim=3), act,
                                                            convbn(f, f, ndim=3)))
            setattr(self, f"confidence2_{s}", GwcHourglass(f, act))
            setattr(self, f"confidence3_{s}", GwcHourglass(f, act))
            for head in ("classif0", "classif1", "classifmid"):
                setattr(self, f"confidence_{head}_{s}", self._classif(f, act))
        for head in ("classif0", "classif1", "classif2"):
            setattr(self, head, self._classif(32, act))
        # the learned range scalars (`cfnet.py:271-274`); flax starts them at 0
        for p in ("gamma_s3", "beta_s3", "gamma_s2", "beta_s2"):
            setattr(self, p, nn.Parameter(torch.zeros(())))

    @staticmethod
    def _classif(c: int, act: nn.Module) -> nn.Sequential:
        return nn.Sequential(convbn(c, c, ndim=3), act, nn.Conv3d(c, 1, 3, padding=1, bias=False))

    def _cost(self, x, head: str) -> torch.Tensor:
        """A classifier head → [B,D,H,W] in the head dtype."""
        return run_seq(x, getattr(self, head))[:, 0].to(head_dtype(self.dtype))

    def _dres(self, v, name0: str, name1: str):
        v = run_seq(v, getattr(self, name0))
        return run_seq(v, getattr(self, name1)) + v

    def _range_and_samples(self, pred, var, gamma, beta, out_hw, scale_pow: int,
                           sample_count: int) -> torch.Tensor:
        """[B, sample_count + 2, h, w] integer disparity samples at `out_hw`
        (`cfnet.py:285-305`): the range pred ∓ ((γ+1)·var + β), doubled and
        upsampled (align corners), clipped and widened to at least
        sample_count + 1, then floor(lo), the floors of the uniform interior
        points, and ceil(hi)."""
        lo = pred - (gamma + 1) * var - beta
        hi = pred + (gamma + 1) * var + beta
        lo = resize_linear_align_corners((lo * 2)[:, None], out_hw)[:, 0]
        hi = resize_linear_align_corners((hi * 2)[:, None], out_hw)[:, 0]
        limit = self.max_disp // (2 ** scale_pow) - 1
        n = sample_count + 1
        widen = (n - hi + lo).clamp(min=0.0) / 2.0
        lo1 = (lo - widen).clamp(0.0, limit)
        hi1 = (hi + widen).clamp(0.0, limit)
        mult = (hi1 - lo1) / (sample_count + 1)
        ks = torch.arange(1.0, sample_count + 1, dtype=lo.dtype, device=lo.device)
        mid = torch.floor(lo1[:, None] + mult[:, None] * ks.reshape(1, -1, 1, 1))
        return torch.cat([torch.floor(lo1)[:, None], mid, torch.ceil(hi1)[:, None]], dim=1)

    def _stage(self, fl, fr, n: int, samples, groups: int, s: str):
        """One warped stage over `samples`: (cost0, the first hourglass's
        output, prob, expected disparity); the first two feed the training
        heads."""
        vol = warped_volumes(fl[f"gw{n}"], fr[f"gw{n}"], fl[f"concat_feature{n}"],
                             fr[f"concat_feature{n}"], samples, groups).to(self.dtype)
        cost0 = self._dres(vol, f"confidence0_{s}", f"confidence1_{s}")
        out1 = getattr(self, f"confidence2_{s}")(cost0)
        out2 = getattr(self, f"confidence3_{s}")(out1)
        prob = torch.softmax(self._cost(out2, f"confidence_classif1_{s}"), dim=1)
        return cost0, out1, prob, (prob * samples).sum(dim=1)

    def _regress_full(self, x, head: str, size) -> torch.Tensor:
        """A 1/8 training head (`cfnet.py:341-344`): its cost, in the head
        dtype, resized with aligned corners to (max_disp, H, W), softmax over
        D, soft-argmax → [B,H,W]."""
        cost = resize_linear_align_corners(self._cost(x, head)[:, None],
                                           (self.max_disp, *size))[:, 0]
        return disparity_regression(torch.softmax(cost, dim=1), self.max_disp)

    def _sample_head(self, x, head: str, samples, scale: float, size) -> torch.Tensor:
        """A warped stage's training head (`cfnet.py:346-349`): the expected
        sample under its softmax, ×scale and resized to [B,H,W]."""
        prob = torch.softmax(self._cost(x, head), dim=1)
        return _up_full((prob * samples).sum(dim=1), scale, size)

    def forward(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        left, right = data["left"].to(self.dtype), data["right"].to(self.dtype)
        h, w = left.shape[-2:]
        if self.training:
            # one call per view, each with its own BatchNorm batch statistics (`cfnet.py:231-233`)
            fl, fr = self.feature_extraction(left), self.feature_extraction(right)
        else:
            fl, fr = siamese(self.feature_extraction, left, right)
        md, g = self.max_disp, self.num_groups
        # K3's wrapper has no backward: training builds the plain volumes under
        # autograd, as the JAX model trains its jnp builder
        gwc = gwc_volume if self.use_kernels and not self.training else build_gwc_volume

        def fused(n, d):
            return torch.cat([gwc(fl[f"gw{n}"].contiguous(), fr[f"gw{n}"].contiguous(), d, g),
                              build_concat_volume(fl[f"concat_feature{n}"],
                                                  fr[f"concat_feature{n}"], d)], dim=1)

        cost0_4 = self._dres(fused(4, md // 8), "dres0", "dres1")
        cost0_5 = self._dres(fused(5, md // 16), "dres0_5", "dres1_5")
        cost0_6 = self._dres(fused(6, md // 32), "dres0_6", "dres1_6")
        out1_4 = self.combine1(cost0_4, cost0_5, cost0_6)
        prob_s4 = torch.softmax(self._cost(self.dres3(out1_4), "classif2"), dim=1)
        pred_s4 = disparity_regression(prob_s4, md // 8)  # [B,H/8,W/8]
        # the spread and the range take the prediction without its gradient
        # (JAX's stop_gradient, `cfnet.py:276` and `:316`); the heads take it with
        cur_s4 = pred_s4.detach()
        dv = torch.arange(md // 8, dtype=prob_s4.dtype, device=prob_s4.device)
        var_s4 = torch.sqrt((prob_s4 * (dv.reshape(1, -1, 1, 1) - cur_s4[:, None]) ** 2).sum(1))

        samples_s3 = self._range_and_samples(cur_s4, var_s4, self.gamma_s3, self.beta_s3,
                                             (h // 4, w // 4), 2, self.sample_count_s3)
        cost0_s3, out1_s3, prob_s3, pred_s3 = self._stage(fl, fr, 3, samples_s3, g, "s3")
        cur_s3 = pred_s3.detach()
        var_s3 = torch.sqrt((prob_s3 * (cur_s3[:, None] - samples_s3) ** 2).sum(1))

        samples_s2 = self._range_and_samples(cur_s3, var_s3, self.gamma_s2, self.beta_s2,
                                             (h // 2, w // 2), 1, self.sample_count_s2)
        cost0_s2, out1_s2, _, pred_s2 = self._stage(fl, fr, 2, samples_s2, g // 2, "s2")
        disp = _up_full(pred_s2, 2.0, (h, w))
        if not self.training:
            return {"disp_pred": disp}
        size = (h, w)
        preds = [self._regress_full(cost0_4, "classif0", size),
                 self._regress_full(out1_4, "classif1", size),
                 _up_full(pred_s4, 8.0, size),
                 self._sample_head(cost0_s3, "confidence_classif0_s3", samples_s3, 4.0, size),
                 self._sample_head(out1_s3, "confidence_classifmid_s3", samples_s3, 4.0, size),
                 _up_full(pred_s3, 4.0, size),
                 self._sample_head(cost0_s2, "confidence_classif0_s2", samples_s2, 2.0, size),
                 self._sample_head(out1_s2, "confidence_classifmid_s2", samples_s2, 2.0, size),
                 disp]
        return {"disp_pred": disp, "disp_preds": preds}

    def get_loss(self, pred: Dict, data: Dict):
        """Σ head_weights · masked smooth-L1 of the nine heads over 0 < gt <
        max_disp (`cfnet.py:364-370`) → (loss, {'loss_disp'})."""
        loss = weighted_heads_loss(pred["disp_preds"], data["disp"], self.max_disp,
                                   self.head_weights)
        return loss, {"loss_disp": loss}
