"""MonSter's blocks, NCHW / NCDHW (counterpart of `openstereo_tpu/models/monster/blocks.py`).

- `FeatTransfer`: the DPT pyramid decoder's four paths → the stereo feature
  pyramid (48, 64, 192, 160 channels at 1/4 … 1/32), top-down through k3 s2
  transposed convs, with 1×1 skips of the mono features;
- `FeatTransferCnet`: one 3×3 conv per GRU scale over the mono features and
  the stems, its output both the hidden state and the context;
- `MixMotionEncoder` and `MixUpdateBlock`: the twin update of the mutual
  refinement, each branch's motion features beside the other's, on IGEV's
  `ConvGRU`, `DispHead`, `pool2x` and `interp_to`;
- `Conv2xNow`, `SimpleUNet` and `REMP`: the full-resolution refinement from
  the warp errors of both disparities;
- `compute_scale_shift`: the closed-form alignment of the mono depth to the
  stereo disparity.

MonSter's 3D hourglass is IGEV's `GeoHourglass` (the same blocks, slopes
and keys; `igev/igev.py`). Three activations meet here: the hourglass's
leaky_relu 0.01, REMP's leaky_relu 0.2 in its first convs, and plain ReLU in
`Conv2xNow` and `SimpleUNet`. Attribute names follow the reference as
`openstereo_tpu/utils/torch_convert.py:convert_monster` reads them.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import disp_warp
from ..igev.update import ConvGRU, DispHead, interp_to, pool2x
from ..layers import apply_norm, conv_norm, head_dtype, leaky_relu, run_conv, run_seq


def _conv_in_relu(in_ch: int, out_ch: int, k: int) -> nn.Sequential:
    """conv with bias, non-affine InstanceNorm, ReLU (keys 0)."""
    return nn.Sequential(nn.Conv2d(in_ch, out_ch, k, padding=k // 2), nn.InstanceNorm2d(out_ch),
                         nn.ReLU())


def _up(in_ch: int, out_ch: int) -> nn.ConvTranspose2d:
    """The bias-free k3 s2 p1 transposed conv with output_padding 1 (×2)."""
    return nn.ConvTranspose2d(in_ch, out_ch, 3, 2, 1, output_padding=1, bias=False)


class FeatTransfer(nn.Module):
    """[p1 @1/4, p2 @1/8, p3 @1/16, p4 @1/32], each `dim` wide → [y4 48, y8 64,
    y16 192, y32 160] (`blocks.py:23-45`). Keys: conv{4,8,16,32}x.0,
    conv_up_{32,16,8}x, res_{16,8,4}x."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv32x = _conv_in_relu(dim, 160, 3)
        self.conv_up_32x = _up(160, 192)
        self.conv16x = _conv_in_relu(dim + 192, 192, 5)
        self.res_16x = nn.Conv2d(dim, 192, 1)
        self.conv_up_16x = _up(192, 64)
        self.conv8x = _conv_in_relu(dim + 64, 64, 5)
        self.res_8x = nn.Conv2d(dim, 64, 1)
        self.conv_up_8x = _up(64, 48)
        self.conv4x = _conv_in_relu(dim + 48, 48, 5)
        self.res_4x = nn.Conv2d(dim, 48, 1)

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        f4, f8, f16, f32 = feats
        y32 = run_seq(f32, self.conv32x)
        y16 = (run_seq(torch.cat([f16, run_conv(y32, self.conv_up_32x)], 1), self.conv16x)
               + run_conv(f16, self.res_16x))
        y8 = (run_seq(torch.cat([f8, run_conv(y16, self.conv_up_16x)], 1), self.conv8x)
              + run_conv(f8, self.res_8x))
        y4 = (run_seq(torch.cat([f4, run_conv(y8, self.conv_up_8x)], 1), self.conv4x)
              + run_conv(f4, self.res_4x))
        return [y4, y8, y16, y32]


class FeatTransferCnet(nn.Module):
    """The mono paths at 1/4, 1/8, 1/16 beside the stems there (48, 96, 192
    channels) → [(c4, c4), (c8, c8), (c16, c16)]: hidden state and context
    are one conv's output (`blocks.py:48-65`). Keys: res_16x, res_8x, res_4x."""

    def __init__(self, dim: int, hidden_dim: int = 128):
        super().__init__()
        self.res_16x = nn.Conv2d(dim + 192, hidden_dim, 3, padding=1)
        self.res_8x = nn.Conv2d(dim + 96, hidden_dim, 3, padding=1)
        self.res_4x = nn.Conv2d(dim + 48, hidden_dim, 3, padding=1)

    def forward(self, mono_feats: Sequence[torch.Tensor], stems: Sequence[torch.Tensor]):
        f4, f8, f16, _ = mono_feats
        s16, s8, s4 = stems
        out = [run_conv(torch.cat([f, s], 1), conv) for f, s, conv in
               ((f4, s4, self.res_4x), (f8, s8, self.res_8x), (f16, s16, self.res_16x))]
        return [(c, c) for c in out]


class MixMotionEncoder(nn.Module):
    """Both branches' lookups, warp errors ("flaws") and disparities → [this
    branch's 63 features, its disparity, the other's 63, the other's
    disparity], 128 channels (`blocks.py:123-143`). Its convs run in the
    lookups' dtype (the flaws are cast to it, as flax's convs cast their
    concatenated input); the disparities join the result in their own
    dtype. Keys: convc1, convc2, convd1, convd2, conv, each also _mono."""

    def __init__(self, cor_planes: int, flaw_ch: int):
        super().__init__()
        for sfx in ("", "_mono"):
            setattr(self, f"convc1{sfx}", nn.Conv2d(cor_planes + flaw_ch, 64, 1))
            setattr(self, f"convc2{sfx}", nn.Conv2d(64, 64, 3, padding=1))
            setattr(self, f"convd1{sfx}", nn.Conv2d(1, 64, 7, padding=3))
            setattr(self, f"convd2{sfx}", nn.Conv2d(64, 64, 3, padding=1))
            setattr(self, f"conv{sfx}", nn.Conv2d(128, 63, 3, padding=1))

    def _branch(self, sfx: str, disp, corr, flaw):
        conv = lambda x, name: F.relu(run_conv(x, getattr(self, f"{name}{sfx}")))  # noqa: E731
        cor = conv(conv(torch.cat([corr, flaw.to(corr.dtype)], 1), "convc1"), "convc2")
        d = conv(conv(disp.to(corr.dtype), "convd1"), "convd2")
        return conv(torch.cat([cor, d], 1), "conv")

    def forward(self, disp, corr, flaw, disp_o, corr_o, flaw_o):
        return torch.cat([self._branch("", disp, corr, flaw), disp,
                          self._branch("_mono", disp_o, corr_o, flaw_o), disp_o], dim=1)


class MixUpdateBlock(nn.Module):
    """The three-scale GRU cascade over `MixMotionEncoder` (`blocks.py:146-170`):
    gru16, then gru08, then gru04 with the motion features, then the
    disparity update and the mask features. hidden_dims are ordered [1/16,
    1/8, 1/4], as `BasicMultiUpdateBlock`'s. Keys: encoder, gru04, gru08,
    gru16, disp_head, mask_feat_4.0."""

    def __init__(self, hidden_dims: Sequence[int] = (128, 128, 128), n_gru_layers: int = 3,
                 cor_planes: int = 162, flaw_ch: int = 96):
        super().__init__()
        hd = list(hidden_dims)
        self.n_gru_layers = n_gru_layers
        self.encoder = MixMotionEncoder(cor_planes, flaw_ch)
        self.gru04 = ConvGRU(hd[2], 128 + hd[1])
        self.gru08 = ConvGRU(hd[1], hd[2] + hd[0] * (n_gru_layers > 2))
        self.gru16 = ConvGRU(hd[0], hd[1])
        self.disp_head = DispHead(hd[2], 256)
        self.mask_feat_4 = nn.Sequential(nn.Conv2d(hd[2], 32, 3, padding=1), nn.ReLU())

    def forward(self, net, inp, flaw, disp, corr, flaw_o, disp_o, corr_o):
        """net, inp per scale [1/4, 1/8, 1/16]; flaw [B,C,H,W], disp
        [B,1,H,W], corr [B,cor_planes,H,W], and the other branch's → (net,
        mask_feat_4, delta_disp)."""
        net = list(net)
        net[2] = self.gru16(net[2], inp[2], pool2x(net[1]))
        extra = [pool2x(net[0])]
        if self.n_gru_layers > 2:
            extra.append(interp_to(net[2], net[1]))
        net[1] = self.gru08(net[1], inp[1], *extra)
        motion = self.encoder(disp, corr, flaw, disp_o, corr_o, flaw_o)
        net[0] = self.gru04(net[0], inp[0], motion, interp_to(net[1], net[0]))
        delta = self.disp_head(net[0])
        return net, F.relu(run_conv(net[0], self.mask_feat_4[0])), delta


class ConvBNAct(nn.Module):
    """A bias-free conv (torch's symmetric padding d·(k-1)/2) or k4 s2 p1
    transposed conv, BatchNorm, then `act` (the reference's BasicConv_now
    with F.relu, `blocks.py:182-191`). Keys: conv, bn."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1,
                 dilation: int = 1, deconv: bool = False, act: Callable = F.relu):
        super().__init__()
        if deconv:
            self.conv = nn.ConvTranspose2d(in_ch, out_ch, 4, 2, 1, bias=False)
        else:
            self.conv = nn.Conv2d(in_ch, out_ch, kernel_size, stride,
                                  dilation * (kernel_size - 1) // 2, dilation, bias=False)
        self.bn = nn.BatchNorm2d(out_ch)
        self.act = act

    def forward(self, x):
        return self.act(apply_norm(run_conv(x, self.conv), self.bn))


class Conv2xNow(nn.Module):
    """A k4 s2 deconv (`deconv`) or a k3 s2 conv to `out_ch`, concatenated with
    the skip (out_ch wide), then a 3×3 conv; BatchNorm and plain ReLU after
    each (`blocks.py:173-191`). Keys: conv1, conv2."""

    def __init__(self, in_ch: int, out_ch: int, deconv: bool = False):
        super().__init__()
        self.conv1 = ConvBNAct(in_ch, out_ch, 3, 2, deconv=deconv)
        self.conv2 = ConvBNAct(2 * out_ch, out_ch, 3, 1)

    def forward(self, x, rem):
        return self.conv2(torch.cat([self.conv1(x), rem], dim=1))


class SimpleUNet(nn.Module):
    """The double-dip UNet (`blocks.py:194-233`): four stride-2 convs (the
    last two dilated 2) down to 1/16, up, down and up again through
    `Conv2xNow`; [B,32,H,W] → [B,out,H,W], H and W multiples of 16. Keys:
    conv{1..4}a, deconv{4..1}a, conv{1..4}b, deconv{4..1}b."""

    def __init__(self, in_ch: int = 32, out_ch: int = 32):
        super().__init__()
        self.conv1a = ConvBNAct(in_ch, 48, 3, 2)
        self.conv2a = ConvBNAct(48, 64, 3, 2)
        self.conv3a = ConvBNAct(64, 96, 3, 2, dilation=2)
        self.conv4a = ConvBNAct(96, 128, 3, 2, dilation=2)
        widths = (in_ch, 48, 64, 96, 128)
        for i in range(4, 0, -1):
            setattr(self, f"deconv{i}a", Conv2xNow(widths[i], widths[i - 1], deconv=True))
        for i in range(1, 5):
            setattr(self, f"conv{i}b", Conv2xNow(widths[i - 1], widths[i]))
        for i in range(4, 1, -1):
            setattr(self, f"deconv{i}b", Conv2xNow(widths[i], widths[i - 1], deconv=True))
        self.deconv1b = Conv2xNow(48, out_ch, deconv=True)

    def forward(self, x):
        r = [x]  # r[i]: the latest map at 1/2^i, each pass replacing it
        for i in range(1, 5):
            r.append(getattr(self, f"conv{i}a")(r[-1]))
        x = r[4]
        for i in range(4, 0, -1):
            r[i - 1] = x = getattr(self, f"deconv{i}a")(x, r[i - 1])
        for i in range(1, 5):
            r[i] = x = getattr(self, f"conv{i}b")(x, r[i])
        for i in range(4, 0, -1):
            x = getattr(self, f"deconv{i}b")(x, r[i - 1])
        return x


class REMP(nn.Module):
    """Full-resolution refinement (`blocks.py:236-274`): each disparity's warp
    error (the right view border-warped, minus the left) beside the left
    view, and each disparity, through conv + BatchNorm + leaky_relu 0.2;
    a dilated conv; `SimpleUNet`; a global gate (pooled, LFE) and a local
    one (LMC) blended; a 3×3 conv to one channel; leaky_relu 0.01 of the
    stereo disparity plus it. disp_mono, disp_stereo [B,1,H,W] (f32), left,
    right [B,3,H,W] → [B,1,H,W] in their dtype. The convs run in the
    caller's compute `dtype`. Keys: conv1_mono, conv1_stereo, conv2_mono,
    conv2_stereo (.0 conv, .1 BN), conv_start, RefinementBlock, LFE.{0,2},
    LMC.{0,1,3}, final_conv."""

    def __init__(self):
        super().__init__()
        for name, cin in (("conv1_mono", 6), ("conv1_stereo", 6), ("conv2_mono", 1),
                          ("conv2_stereo", 1)):
            setattr(self, name, nn.Sequential(*conv_norm(cin, 16, 3, norm="batch")))
        self.conv_start = ConvBNAct(64, 32, 3, dilation=2)
        self.RefinementBlock = SimpleUNet(32, 32)
        self.LFE = nn.Sequential(nn.Conv2d(32, 64, 1), nn.ReLU(), nn.Conv2d(64, 32, 1),
                                 nn.Sigmoid())
        self.LMC = nn.Sequential(nn.Conv2d(32, 32, 3, padding=1), nn.Conv2d(32, 64, 3, padding=1),
                                 nn.ReLU(), nn.Conv2d(64, 32, 3, padding=1), nn.Sigmoid())
        self.final_conv = nn.Conv2d(32, 1, 3, padding=1)

    def forward(self, disp_mono, disp_stereo, left, right, dtype: torch.dtype):
        cbn = leaky_relu(0.2)
        flaw_m = disp_warp(right, disp_mono[:, 0], "border", torch_unaligned=True)[0] - left
        flaw_s = disp_warp(right, disp_stereo[:, 0], "border", torch_unaligned=True)[0] - left
        x = torch.cat([
            cbn(run_seq(torch.cat([flaw_m, left], 1).to(dtype), self.conv1_mono)),
            cbn(run_seq(disp_mono.to(dtype), self.conv2_mono)),
            cbn(run_seq(torch.cat([flaw_s, left], 1).to(dtype), self.conv1_stereo)),
            cbn(run_seq(disp_stereo.to(dtype), self.conv2_stereo))], dim=1)
        x = self.RefinementBlock(self.conv_start(x))
        gap = x.to(head_dtype(x.dtype)).mean((2, 3), keepdim=True).to(x.dtype)
        low = torch.sigmoid(run_conv(F.relu(run_conv(gap, self.LFE[0])), self.LFE[2]))
        motif = run_conv(run_conv(x, self.LMC[0]), self.LMC[1])
        motif = torch.sigmoid(run_conv(F.relu(motif), self.LMC[3]))
        x = run_conv((1 - motif) * low + motif * x, self.final_conv)
        return leaky_relu(0.01)(disp_stereo + x)


def compute_scale_shift(mono: torch.Tensor, disp: torch.Tensor):
    """The least-squares scale and shift per batch element that map the mono
    depth onto the stereo disparity (`blocks.py:277-303`): mono, disp
    [B,H,W] f32 → (scale [B], shift [B]). The mask is disp > 0, mono > 1e-2
    and mono above the sorted value at index int(0.2·N) (not an
    interpolated percentile); the masked moments are f32 sums, and the 2×2
    normal equations carry a 1e-6 ridge on their diagonal."""
    b = mono.shape[0]
    flat = mono.reshape(b, -1)
    thresh = flat.sort(dim=1).values[:, int(0.2 * flat.shape[1])]
    w = ((disp > 0) & (mono > 1e-2) & (mono > thresh[:, None, None])).to(mono.dtype)
    total = lambda x: x.sum(dim=(1, 2))  # noqa: E731
    n, sx, sxx = total(w), total(w * mono), total(w * mono * mono)
    sy, sxy = total(w * disp), total(w * mono * disp)
    a11, a12, a22 = sxx + 1e-6, sx, n + 1e-6
    det = a11 * a22 - a12 * a12
    return (a22 * sxy - a12 * sy) / det, (a11 * sy - a12 * sxy) / det
