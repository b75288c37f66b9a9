"""CasPSMNet and CasGwcNet, NCHW / NCDHW (counterpart of
`openstereo_tpu/models/casnet/casnet.py`).

Stage 1 samples the whole disparity range coarsely at 1/4; stage 2
re-samples a narrow range around the first prediction at 1/2, widened by
a neighbourhood max/min search (USING_NS). Each stage warps the right
features to every per-pixel disparity sample (`ops.sample_along_w`):
concat volumes for CasPSMNet, group-wise + concat volumes for CasGwcNet.
Each runs a redir-skip 3D hourglass stack, upsamples its cost
trilinearly to (D, H, W) and soft-argmaxes it against the sample grid.
Eval runs the last head of each stage; training runs all four
(`classif0`-`classif3`), with the features run once per view.

No kernel of the port lies on these paths: the warped volumes are gathers
in plain PyTorch, as they are jnp in the JAX package, and every 3D conv
runs on cuDNN.

Attribute names follow the reference OpenStereo cascade state_dicts, as
`openstereo_tpu/utils/torch_convert.py:convert_casnet` reads them:
`feature_extraction.{firstconv_a,firstconv_b,layer1..4,...}` and
`cost_agg.{i}.{dres0,dres1,dres2..4,classif0..3}`.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import resize_bilinear, resize_linear, sample_along_w, upsample_nearest
from ..gwcnet.gwcnet import GwcHourglass
from ..layers import convbn, head_dtype, run_conv, run_seq, siamese
from ..losses import weighted_heads_loss
from ..psmnet.psmnet import res_layer


def regression_with_samples(prob: torch.Tensor, samples: torch.Tensor) -> torch.Tensor:
    """Soft-argmax against a per-pixel sample grid: [B,D,H,W]·[B,D,H,W] → [B,H,W]."""
    return (prob * samples).sum(dim=1)


def max_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """[B,H,W] max-pooled k×k, stride 1, padded with −inf (SAME)."""
    return F.max_pool2d(x[:, None], k, 1, k // 2)[:, 0]


def disp_range_samples(cur_disp, ndisp: int, interval: float, shape, max_disp: float,
                       using_ns: bool, ns_size: int, device=None) -> torch.Tensor:
    """Per-pixel disparity samples [B, ndisp, H, W] in f32 (`casnet.py:56-94`):
    the whole range without a previous disparity; else `ndisp` samples
    around it, or with `using_ns` the range of its ns_size neighbourhood at
    1/4 (the reference's |min-pool| kept: `casnet.py:75-78`), widened to
    ndisp/4·interval, sampled ndisp/4 times and resized to (ndisp, H, W)."""
    b, h, w = shape
    steps = torch.arange(ndisp, dtype=torch.float32, device=device).reshape(1, -1, 1, 1)
    if cur_disp is None:  # f32 scalars, as the JAX program's
        lo = torch.tensor(0.0 - ndisp / 2 * interval, device=device).clamp(min=0.0)
        hi = (lo + (ndisp - 1) * interval).clamp(max=max_disp)
        return (lo + steps * ((hi - lo) / (ndisp - 1))).expand(b, ndisp, h, w)
    if not using_ns:
        lo = cur_disp - ndisp / 2 * interval
        hi = cur_disp + ndisp / 2 * interval
        step = (hi - lo) / (ndisp - 1)
        return lo[:, None] + steps * step[:, None]
    small = resize_linear((cur_disp / 4.0)[:, None], (h // 4, w // 4))[:, 0]
    lo = max_pool_same(-small, ns_size).abs()
    hi = max_pool_same(small, ns_size)
    comp = (ndisp // 4 * interval - (hi - lo)).clamp(min=0.0) / 2.0
    lo = (lo - comp).clamp(0.0, max_disp)
    hi = (hi + comp).clamp(0.0, max_disp)
    nd4 = ndisp // 4
    step = (hi - lo) / (nd4 - 1)
    samples4 = lo[:, None] + steps[:, :nd4] * step[:, None]
    # back to full-resolution disparity units as the samples are upsampled
    return resize_linear((samples4 * 4.0)[:, None], (ndisp, h, w))[:, 0]


def build_warped_concat_volume(x, y, samples, zero_left: bool = False) -> torch.Tensor:
    """[B,C,H,W] ×2 + samples [B,D,H,W] → [B,2C,D,H,W]: the left features,
    zeroed where the match falls out of frame with `zero_left` (CasGwcNet;
    CasPSMNet keeps them), and the right features warped to each sample,
    zero outside the frame (`casnet.py:97-113`)."""
    b, c, h, w = x.shape
    d = samples.shape[1]
    xs = x[:, :, None].expand(b, c, d, h, w)
    mw = torch.arange(w, dtype=samples.dtype, device=samples.device)
    if zero_left:
        xs = xs.masked_fill((mw < samples)[:, None], 0.0)
    return torch.cat([xs, sample_along_w(y, mw - samples)], dim=1)


def build_warped_gwc_volume(x, y, samples, num_groups: int) -> torch.Tensor:
    """Warped group-wise correlation [B,G,D,H,W], left features zeroed where
    the match falls out of frame (`casnet.py:116-126`); the group mean
    accumulates in f32, as `jnp.mean` of bf16 does."""
    b, c, h, w = x.shape
    d = samples.shape[1]
    mw = torch.arange(w, dtype=samples.dtype, device=samples.device)
    xs = x[:, :, None].expand(b, c, d, h, w).masked_fill((mw < samples)[:, None], 0.0)
    prod = xs * sample_along_w(y, mw - samples)
    return prod.reshape(b, num_groups, c // num_groups, d, h, w).mean(dim=2)


def _convbn_relu(in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1,
                 ndim: int = 2) -> List[nn.Module]:
    return [convbn(in_ch, out_ch, kernel_size, stride, ndim=ndim), nn.ReLU()]


class CasCostAggregation(nn.Module):
    """dres0/dres1 + three redir hourglasses + four heads (`casnet.py:129-180`):
    volume → the expected disparity over `samples` of the last head; in
    training, of each head (`casnet.py:157-164`)."""

    def __init__(self, in_ch: int, c: int = 32):
        super().__init__()
        self.dres0 = nn.Sequential(*_convbn_relu(in_ch, c, ndim=3), *_convbn_relu(c, c, ndim=3))
        self.dres1 = nn.Sequential(*_convbn_relu(c, c, ndim=3), convbn(c, c, ndim=3))
        for i in (2, 3, 4):
            setattr(self, f"dres{i}", GwcHourglass(c))
        for j in range(4):
            setattr(self, f"classif{j}", nn.Sequential(
                *_convbn_relu(c, c, ndim=3), nn.Conv3d(c, 1, 3, padding=1, bias=False)))

    def stages(self, volume) -> Tuple[torch.Tensor, ...]:
        """(cost0, out1, out2, out3): the pre-hourglass cost and each
        hourglass's output, the inputs of `classif0`..`classif3`."""
        cost0 = run_seq(volume, self.dres0)
        outs = [run_seq(cost0, self.dres1) + cost0]
        for i in (2, 3, 4):
            outs.append(getattr(self, f"dres{i}")(outs[-1]))
        return tuple(outs)

    def cost(self, volume) -> torch.Tensor:
        """volume → the last head's cost [B,1,D,H,W] in the volume's dtype."""
        return run_seq(self.stages(volume)[3], self.classif3)

    def forward(self, volume, fine_dhw: Tuple[int, int, int], samples):
        """→ the last head's disparity [B,H,W]; in training the list of the
        four heads' (classif0..classif3)."""
        def regress(cost):
            cost = cost.to(head_dtype(volume.dtype))
            prob = torch.softmax(resize_linear(cost, fine_dhw)[:, 0], dim=1)
            return regression_with_samples(prob, samples)

        if not self.training:
            return regress(self.cost(volume))
        return [regress(run_seq(x, getattr(self, f"classif{j}")))
                for j, x in enumerate(self.stages(volume))]


def _cascade_trunk(m: nn.Module):
    """The residual trunk both cascade features share: firstconv_a (1/1),
    firstconv_b (1/2), layer1 (32 at 1/2), layer2 (64 at 1/4), layer3 and the
    dilated layer4 (128 at 1/4)."""
    m.firstconv_a = nn.Sequential(*_convbn_relu(3, 32), *_convbn_relu(32, 32))
    m.firstconv_b = nn.Sequential(*_convbn_relu(32, 32, 3, 2))
    m.layer1 = res_layer(32, 32, 3, nested=True)
    m.layer2 = res_layer(32, 64, 16, stride=2, nested=True)
    m.layer3 = res_layer(64, 128, 3, nested=True)
    m.layer4 = res_layer(128, 128, 3, dilation=2, nested=True)


class PSMCascadeFeatures(nn.Module):
    """SPP trunk + FPN heads: stage 1 32 channels at 1/4, stage 2 16 at 1/2
    (`casnet.py:183-240`)."""

    def __init__(self, num_stage: int = 2):
        super().__init__()
        _cascade_trunk(self)
        for k, pool in enumerate((64, 32, 16, 8), start=1):
            setattr(self, f"branch{k}",
                    nn.Sequential(nn.AvgPool2d(pool), *_convbn_relu(128, 32, 1)))
        self.inner0 = nn.Sequential(*_convbn_relu(320, 128), nn.Conv2d(128, 32, 1))
        self.lastconv = nn.Conv2d(32, 32, 3, 1, 1, bias=False)
        self.num_stage = num_stage
        for i, oc in enumerate((16, 8)[:num_stage - 1], start=1):  # skips s2, s1: 32 each
            setattr(self, f"inner{i}", nn.Conv2d(32, 32, 1))
            setattr(self, f"out{i + 1}", nn.Conv2d(32, oc, 3, 1, 1, bias=False))

    def forward(self, x) -> List[torch.Tensor]:
        s1 = run_seq(x, self.firstconv_a)
        s2 = self.layer1(run_seq(s1, self.firstconv_b))
        raw = self.layer2(s2)
        skip = self.layer4(self.layer3(raw))
        h4, w4 = skip.shape[-2:]
        branches = []
        for k in range(4, 0, -1):  # pools 8, 16, 32, 64: the JAX concat order
            branch = getattr(self, f"branch{k}")
            ph, pw = min(branch[0].kernel_size, h4), min(branch[0].kernel_size, w4)
            b = run_seq(F.avg_pool2d(skip, (ph, pw), (ph, pw)), branch[1:])
            branches.append(resize_bilinear(b, (h4, w4)))
        feat = run_seq(torch.cat([raw, skip] + branches, dim=1), self.inner0)
        outs = [run_conv(feat, self.lastconv)]
        intra = feat
        for i, sk in enumerate((s2, s1)[:self.num_stage - 1], start=1):
            intra = upsample_nearest(intra, 2) + run_conv(sk, getattr(self, f"inner{i}"))
            outs.append(run_conv(intra, getattr(self, f"out{i + 1}")))
        return outs


class GwcCascadeFeatures(nn.Module):
    """The trunk without SPP: stage 1 (320 group-wise, 12 concat channels)
    at 1/4, stage 2 (160, 6) at 1/2 (`casnet.py:243-293`)."""

    def __init__(self, num_stage: int = 2, concat_channels: int = 12):
        super().__init__()
        _cascade_trunk(self)
        self.out1_cat = nn.Sequential(*_convbn_relu(320, 128),
                                      nn.Conv2d(128, concat_channels, 1, bias=False))
        self.num_stage = num_stage
        for i, gc in enumerate((160, 80)[:num_stage - 1], start=1):  # skips s2, s1: 32 each
            setattr(self, f"inner{i}", nn.Conv2d(32, 320, 1))
            setattr(self, f"out{i + 1}", nn.Conv2d(320, gc, 3, 1, 1, bias=False))
            setattr(self, f"out{i + 1}_cat", nn.Conv2d(gc, concat_channels // 2 ** i, 1,
                                                       bias=False))

    def forward(self, x) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        s1 = run_seq(x, self.firstconv_a)
        s2 = self.layer1(run_seq(s1, self.firstconv_b))
        l2 = self.layer2(s2)
        l3 = self.layer3(l2)
        feat = torch.cat([l2, l3, self.layer4(l3)], dim=1)  # 320 at 1/4
        outs = [(feat, run_seq(feat, self.out1_cat))]
        intra = feat
        for i, sk in enumerate((s2, s1)[:self.num_stage - 1], start=1):
            intra = upsample_nearest(intra, 2) + run_conv(sk, getattr(self, f"inner{i}"))
            g = run_conv(intra, getattr(self, f"out{i + 1}"))
            outs.append((g, run_conv(g, getattr(self, f"out{i + 1}_cat"))))
        return outs


class _CascadeBase(nn.Module):
    """The cascade's stage loop (`casnet.py:276-325`): per stage, the sample grid at
    full resolution, its copy at the stage's scale, the volume, and the
    aggregation's prediction, which seeds the next stage; in training also
    {'stage1', 'stage2': each stage's four head predictions}."""

    head_weights = (0.5, 0.5, 0.7, 1.0)
    stage_weights = (0.5, 1.0, 2.0)

    def __init__(self, max_disp: int = 192, ndisps: Sequence[int] = (48, 24),
                 disp_interval_pixel: Sequence[float] = (4.0, 1.0), using_ns: bool = True,
                 ns_size: int = 3, grad_method: str = "detach",
                 cr_base_chs: Sequence[int] = (32, 32, 16), dtype: torch.dtype = torch.float32):
        super().__init__()
        if len(ndisps) > 2:
            raise NotImplementedError("the port's cascades run 2 stages, as every config; three "
                                      "stages are left out on purpose (ROADMAP queue 1)")
        self.max_disp, self.ndisps = max_disp, tuple(ndisps)
        self.disp_interval_pixel = tuple(disp_interval_pixel)
        self.using_ns, self.ns_size, self.grad_method = using_ns, ns_size, grad_method
        self.cr_base_chs = tuple(cr_base_chs)
        self.dtype = dtype

    def build_volume(self, si, fl, fr, samples_s):
        raise NotImplementedError

    def forward(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        left, right = data["left"].to(self.dtype), data["right"].to(self.dtype)
        b, h, w = left.shape[0], left.shape[2], left.shape[3]
        if self.training:
            # one call per view, each with its own BatchNorm batch statistics
            # (`casnet.py:336-338`, `:359-361`)
            feats_l, feats_r = self.feature_extraction(left), self.feature_extraction(right)
        else:
            feats_l, feats_r = siamese(self.feature_extraction, left, right)
        out, pred = {}, None
        for si, ndisp in enumerate(self.ndisps):
            scale = (4, 2, 1)[si]
            # GRAD_METHOD detach: the next stage's range takes the prediction
            # without its gradient (`casnet.py:297`); undetach lets it flow
            # through the sample grids and the warps' positions
            cur = pred.detach() if pred is not None and self.grad_method == "detach" else pred
            samples = disp_range_samples(cur, ndisp, self.disp_interval_pixel[si], (b, h, w),
                                         float(self.max_disp), self.using_ns, self.ns_size,
                                         left.device)
            samples_s = resize_linear((samples / scale)[:, None],
                                      (ndisp // scale, h // scale, w // scale))[:, 0]
            volume = self.build_volume(si, feats_l[si], feats_r[si], samples_s)
            res = self.cost_agg[si](volume, (ndisp, h, w), samples)
            if self.training:
                out[f"stage{si + 1}"] = res
            pred = res[-1] if self.training else res
        out["disp_pred"] = pred
        return out

    def get_loss(self, pred: Dict, data: Dict):
        """Σ over the stages of stage_weights · Σ head_weights · masked smooth-L1
        of its four heads over 0 < gt < max_disp (`casnet.py:314-325`) →
        (loss, {'loss_disp'})."""
        loss = 0.0
        for si in range(len(self.ndisps)):
            loss = loss + self.stage_weights[si] * weighted_heads_loss(
                pred[f"stage{si + 1}"], data["disp"], self.max_disp, self.head_weights)
        return loss, {"loss_disp": loss}


class CasPSMNet(_CascadeBase):
    """Cascade PSMNet: warped concat volumes over the SPP-FPN features.
    forward(data) → {'disp_pred': [B,H,W]} (eval); H, W multiples of 16."""

    def __init__(self, max_disp: int = 192, ndisps: Sequence[int] = (48, 24),
                 disp_interval_pixel: Sequence[float] = (4.0, 1.0), using_ns: bool = True,
                 ns_size: int = 3, grad_method: str = "detach",
                 cr_base_chs: Sequence[int] = (32, 32, 16), dtype: torch.dtype = torch.float32):
        super().__init__(max_disp, ndisps, disp_interval_pixel, using_ns, ns_size, grad_method,
                         cr_base_chs, dtype)
        self.feature_extraction = PSMCascadeFeatures(len(self.ndisps))
        self.cost_agg = nn.ModuleList(
            CasCostAggregation(2 * ch, c) for ch, c in zip((32, 16), self.cr_base_chs))

    def build_volume(self, si, fl, fr, samples_s):
        return build_warped_concat_volume(fl, fr, samples_s)


class CasGwcNet(_CascadeBase):
    """Cascade GwcNet: warped group-wise + concat volumes over the FPN
    features without SPP. forward(data) → {'disp_pred': [B,H,W]} (eval)."""

    def __init__(self, max_disp: int = 192, ndisps: Sequence[int] = (48, 24),
                 disp_interval_pixel: Sequence[float] = (4.0, 1.0), using_ns: bool = True,
                 ns_size: int = 3, grad_method: str = "detach",
                 cr_base_chs: Sequence[int] = (32, 32, 16),
                 num_groups: Sequence[int] = (40, 20, 10), dtype: torch.dtype = torch.float32):
        super().__init__(max_disp, ndisps, disp_interval_pixel, using_ns, ns_size, grad_method,
                         cr_base_chs, dtype)
        self.num_groups = tuple(num_groups)
        self.feature_extraction = GwcCascadeFeatures(len(self.ndisps))
        self.cost_agg = nn.ModuleList(
            CasCostAggregation(g + 2 * cc, c)
            for g, cc, c in zip(self.num_groups, (12, 6), self.cr_base_chs))

    def build_volume(self, si, fl, fr, samples_s):
        gwc = build_warped_gwc_volume(fl[0], fr[0], samples_s, self.num_groups[si])
        cat = build_warped_concat_volume(fl[1], fr[1], samples_s, zero_left=True)
        return torch.cat([gwc, cat], dim=1)
