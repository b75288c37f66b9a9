"""FADNet, NCHW (counterpart of `openstereo_tpu/models/fadnet/fadnet.py`).

A shared 7×7-stem residual encoder (1/2..1/8) on both views → a
correlation volume of D/8 + 16 shifts at 1/8 beside redirected left
features → DispNetC: an encoder to 1/64 and a 7-scale deconv pyramid of
flows → the right view warped to the left with the full-resolution flow,
and an 11-channel error input (left, right, warped, flow, ‖left −
warped‖) → DispNetRes: the same pyramid predicting residuals added to the
first one's flows. The disparity is the last full-resolution flow; training
returns both 7-scale pyramids (`flows_c`, `flows_res`) for the loss.

With `use_kernels` on (the default) the correlation volume goes through
the CUDA kernel K1 (`ops.corr_volume`; on a CPU tensor, its plain
version) in eval; off, and in training, through the plain builder. The warp
is a gather (`ops.bilinear_sampler`), differentiable in its coordinates,
so the gradient reaches the first flow through it, as in JAX.

Images stay in the caller's dtype outside the convs, as in the JAX model,
whose convs cast their inputs to the compute dtype: the warp samples the
f32 right image, at coordinates formed in the flow's dtype.

Attribute names follow the reference OpenStereo FADNet state_dict, as
`openstereo_tpu/utils/torch_convert.py:convert_fadnet` reads it:
`backbone.{conv1.0,conv2,conv3}`, `cost_processor.{conv_redir,conv3_1,
conv4..conv6_1,pred_flowN,upconvN.0,upflowN+1toN,iconvN}` and
`disp_predictor.{conv1.0,conv2..conv6_1,pred_resN,...}`; each residual
block `conv1, bn1, conv2, bn2, shortcut.{0,1}`. `iconvN` is a stride-1
transposed conv, as in the reference.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import bilinear_sampler, corr_volume, correlation_volume
from ..layers import _in_dtype, apply_norm, leaky_relu, run_conv, run_seq, siamese
from ..losses import flow_pyramid_loss

_leaky = leaky_relu(0.1)


class LeakyReLU(nn.Module):
    """`layers.leaky_relu(0.1)` (the slope rounded to x's dtype, 3g) as a
    module, for the reference's Sequential(conv, LeakyReLU)."""

    def forward(self, x):
        return _leaky(x)


class DynamicConv(nn.Module):
    """The reference's DynamicConv2d (`submodule.py:261-334`), bias-free: a
    conv over the input channels it is given. The reference sizes its
    weight for a MAX_RANGE of 400 and slices it to the actual input; a
    checkpoint's weight is sliced the same way when it loads."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride, (kernel_size - 1) // 2,
                              bias=False)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        key = prefix + "conv.weight"
        if key in state_dict:
            state_dict[key] = state_dict[key][:, :self.conv.in_channels]
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


def _conv(m: nn.Module) -> nn.Module:
    return m.conv if isinstance(m, DynamicConv) else m


class FadResBlock(nn.Module):
    """conv-bn-relu → conv-bn, + x or a 1×1 conv-bn shortcut, → relu
    (`fadnet.py:36-66`). Convs carry biases; `dyres` drops those of conv1
    and the shortcut (DynamicConv2d)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1, dyres: bool = False):
        super().__init__()
        self.conv1 = (DynamicConv(in_ch, out_ch, 3, stride) if dyres
                      else nn.Conv2d(in_ch, out_ch, 3, stride, 1))
        self.bn1 = nn.BatchNorm2d(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, 1, 1)
        self.bn2 = nn.BatchNorm2d(out_ch)
        self.shortcut = None
        if stride != 1 or in_ch != out_ch:
            self.shortcut = nn.Sequential(
                DynamicConv(in_ch, out_ch, 1, stride) if dyres
                else nn.Conv2d(in_ch, out_ch, 1, stride), nn.BatchNorm2d(out_ch))

    def forward(self, x):
        y = F.relu(apply_norm(run_conv(x, _conv(self.conv1)), self.bn1))
        y = apply_norm(run_conv(y, self.conv2), self.bn2)
        if self.shortcut is not None:
            x = apply_norm(run_conv(x, _conv(self.shortcut[0])), self.shortcut[1])
        return F.relu(y + x)


def stem(in_ch: int, out_ch: int) -> nn.Sequential:
    """7×7 stride-2 conv with bias + leaky_relu(0.1)."""
    return nn.Sequential(nn.Conv2d(in_ch, out_ch, 7, 2, 3), LeakyReLU())


# decoder feature multipliers per level 5..0 (`fadnet.py:113`)
WIDTHS = (16, 8, 4, 2, 1, 1)


class PyramidDecoder(nn.Module):
    """Base of the two stages: `conv4`..`conv6_1` (`Encoder456`) and the
    7-scale flow pyramid (`fadnet.py:69-131`), whose prediction convs are
    named `{pred}N`. Skip widths are those of FADNet's encoders."""

    pred = "pred_flow"

    def __init__(self, e: int, d: int):
        super().__init__()
        for name, cin, cout, s in (("conv4", 4 * e, 8 * e, 2), ("conv4_1", 8 * e, 8 * e, 1),
                                   ("conv5", 8 * e, 16 * e, 2), ("conv5_1", 16 * e, 16 * e, 1),
                                   ("conv6", 16 * e, 32 * e, 2), ("conv6_1", 32 * e, 32 * e, 1)):
            setattr(self, name, FadResBlock(cin, cout, s))
        skips = (16 * e, 8 * e, 4 * e, 2 * e, e, 3)  # conv5b, conv4b, conv3b, conv2, conv1, image
        setattr(self, f"{self.pred}6", nn.Conv2d(32 * e, 1, 3, 1, 1, bias=False))
        x_ch = 32 * e
        for i, lvl in enumerate(range(5, -1, -1)):
            f = d * WIDTHS[i]
            setattr(self, f"upconv{lvl}", nn.Sequential(
                nn.ConvTranspose2d(x_ch, f, 4, 2, 1, bias=False), LeakyReLU()))
            setattr(self, f"upflow{lvl + 1}to{lvl}", nn.ConvTranspose2d(1, 1, 4, 2, 1, bias=False))
            setattr(self, f"iconv{lvl}", nn.ConvTranspose2d(f + 1 + skips[i], f, 3, 1, 1))
            setattr(self, f"{self.pred}{lvl}", nn.Conv2d(f, 1, 3, 1, 1, bias=False))
            x_ch = f

    def encode456(self, conv3b):
        c4 = self.conv4_1(self.conv4(conv3b))
        c5 = self.conv5_1(self.conv5(c4))
        return c4, c5, self.conv6_1(self.conv6(c5))

    def decode(self, skips: List[torch.Tensor],
               base_flows: Optional[List[torch.Tensor]] = None) -> List[torch.Tensor]:
        """skips [conv6b, conv5b, conv4b, conv3b, conv2, conv1, image], coarse
        to fine → flows [full res, ..., 1/64], each [B,1,h,w]. With
        `base_flows` the heads add their residuals to them and every flow is
        relu'd; without, only the full-resolution one."""
        residual = base_flows is not None
        flows = [None] * 7
        x = skips[0]
        pr = run_conv(x, getattr(self, f"{self.pred}6"))
        if residual:
            pr = pr + base_flows[6]
        flows[6] = pr
        for i, lvl in enumerate(range(5, -1, -1)):
            up = run_seq(x, getattr(self, f"upconv{lvl}"))
            uf = run_conv(pr, getattr(self, f"upflow{lvl + 1}to{lvl}"))
            x = run_conv(torch.cat([up, uf, skips[1 + i]], 1), getattr(self, f"iconv{lvl}"))
            pr = run_conv(x, getattr(self, f"{self.pred}{lvl}"))
            if residual:
                pr = pr + base_flows[lvl]
            flows[lvl] = pr
        if residual:
            return [F.relu(f) for f in flows]
        flows[0] = F.relu(flows[0])
        return flows


class CostProcessor(PyramidDecoder):
    """DispNetC's correlation-side trunk (`conv_redir`, the DyRes `conv3_1`)
    and its pyramid."""

    def __init__(self, e: int, d: int, corr_ch: int):
        super().__init__(e, d)
        self.conv_redir = FadResBlock(4 * e, e)
        self.conv3_1 = FadResBlock(e + corr_ch, 4 * e, dyres=True)


class DispPredictor(PyramidDecoder):
    """DispNetRes: its own encoder on the 11-channel error input and the
    residual pyramid."""

    pred = "pred_res"

    def __init__(self, e: int, d: int, in_ch: int = 11):
        super().__init__(e, d)
        self.conv1 = stem(in_ch, e)
        self.conv2 = FadResBlock(e, 2 * e, 2)
        self.conv3 = FadResBlock(2 * e, 4 * e, 2)
        self.conv3_1 = FadResBlock(4 * e, 4 * e)


class Backbone(nn.Module):
    """The shared stage-1 encoder: conv1 (1/2), conv2 (1/4), conv3 (1/8)."""

    def __init__(self, e: int, in_ch: int = 3):
        super().__init__()
        self.conv1 = stem(in_ch, e)
        self.conv2 = FadResBlock(e, 2 * e, 2)
        self.conv3 = FadResBlock(2 * e, 4 * e, 2)

    def forward(self, x):
        c1 = run_seq(x, self.conv1)
        c2 = self.conv2(c1)
        return [c1, c2, self.conv3(c2)]


class FADNet(nn.Module):
    """forward(data) → {'disp_pred': [B,H,W]}, in the compute dtype as in the
    JAX model (its last flow has no softmax head); in training also
    {'flows_c', 'flows_res': [B,1,H/2^i,W/2^i] for i = 0..6}.

    data['left'] / data['right']: [B,3,H,W] normalized images, H and W
    multiples of 64. `dtype` is the compute dtype of the convs and the
    flows (bf16 on the main path); parameters stay f32.
    """

    use_kernels = True

    def __init__(self, max_disp: int = 192, encoder_ratio: int = 16, decoder_ratio: int = 16,
                 input_channel: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.max_disp = max_disp
        self.dtype = dtype
        e, d = 2 * encoder_ratio, 2 * decoder_ratio
        self.corr_disp = max_disp // 8 + 16
        self.backbone = Backbone(e, input_channel)
        self.cost_processor = CostProcessor(e, d, self.corr_disp)
        self.disp_predictor = DispPredictor(e, d, 3 * input_channel + 2)

    def warp_inputs(self, left, right, flow):
        """The stage-2 input (`fadnet.py:178-198`): right warped to the left
        with `flow` [B,1,H,W], with the reference's coordinate quirk kept: its
        grid is normalised by 2x/(W−1) − 1 but sampled with align_corners off,
        so the source is (x − flow)·W/(W−1) − 0.5 and y·H/(H−1) − 0.5, each
        formed in the flow's dtype (the scale factors rounded to it first,
        as JAX's weakly typed constants are) → [B,11,H,W] in the images'
        dtype."""
        _, _, hh, ww = right.shape
        fl = flow[:, 0]
        dt = fl.dtype
        xs = torch.arange(ww, dtype=dt, device=fl.device)[None, None, :]
        ys = torch.arange(hh, dtype=dt, device=fl.device)[None, :, None]
        src_x = (xs - fl) * _in_dtype(ww / max(ww - 1, 1), dt) - 0.5
        src_y = (ys * _in_dtype(hh / max(hh - 1, 1), dt) - 0.5) + torch.zeros_like(fl)
        warped = bilinear_sampler(right, torch.stack([src_x, src_y], dim=-1))
        diff = left - warped
        norm_diff = torch.sqrt((diff * diff).sum(dim=1, keepdim=True) + 1e-8)
        return torch.cat([left, right, warped, flow.to(left.dtype), norm_diff], dim=1)

    def forward(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        left, right = data["left"], data["right"]
        dt = self.dtype
        if self.training:
            # one call per view, each with its own BatchNorm batch statistics (`fadnet.py:164-166`)
            (c1l, c2l, c3l), (_, _, c3r) = self.backbone(left.to(dt)), self.backbone(right.to(dt))
        else:
            (c1l, c2l, c3l), (_, _, c3r) = siamese(self.backbone, left.to(dt), right.to(dt))
        # K1's wrapper has no backward: training builds the plain volume under
        # autograd, as the JAX model trains its jnp builder
        corr = corr_volume if self.use_kernels and not self.training else correlation_volume
        cp = self.cost_processor
        vol = _leaky(corr(c3l.contiguous(), c3r.contiguous(), self.corr_disp))
        conv3b = cp.conv3_1(torch.cat([cp.conv_redir(c3l), vol], 1))
        c4b, c5b, c6b = cp.encode456(conv3b)
        flows_c = cp.decode([c6b, c5b, c4b, conv3b, c2l, c1l, left.to(dt)])

        dp = self.disp_predictor
        r1 = run_seq(self.warp_inputs(left, right, flows_c[0]).to(dt), dp.conv1)
        r2 = dp.conv2(r1)
        r3b = dp.conv3_1(dp.conv3(r2))
        r4b, r5b, r6b = dp.encode456(r3b)
        flows_res = dp.decode([r6b, r5b, r4b, r3b, r2, r1, left.to(dt)], base_flows=flows_c)
        out = {"disp_pred": flows_res[0][:, 0]}
        if self.training:
            out.update(flows_c=flows_c, flows_res=flows_res)
        return out

    def get_loss(self, pred: Dict, data: Dict):
        """The two flow pyramids' weighted masked smooth-L1 against the pooled
        ground truth (`fadnet.py:216-227`, `losses.flow_pyramid_loss`) →
        (loss, {'loss_disp'})."""
        loss = flow_pyramid_loss((pred["flows_c"], pred["flows_res"]), data["disp"],
                                 self.max_disp)
        return loss, {"loss_disp": loss}
