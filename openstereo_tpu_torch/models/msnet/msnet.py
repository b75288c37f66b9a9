"""MobileStereoNet 3D and 2D eval, NCHW / NCDHW (counterpart of
`openstereo_tpu/models/msnet/msnet.py`).

A shared mobile trunk (MobileV2 stem, MobileV1 residual stages; concat of
l2, l3, l4 = 320 channels at 1/4) as one siamese 2B batch, then:

- MSNet3D: the 40-group correlation volume [B,40,D/4,H/4,W/4] (the CUDA
  kernel K3 with `use_kernels` on, `ops.gwc_volume`; else the plain
  builder), MobileV2Residual3D blocks and three 3D hourglasses, `classif3`,
  a trilinear upsample to [B,D,H,W] and the soft-argmax;
- MSNet2D: the interlaced volume. Per shift d the left and d-shifted right
  32-channel descriptors alternate L0, R0, L1, R1, ...; all D/4 shifts go
  as one batch through a strided 3D conv stack over the 64 interleaved
  channels taken as depth, which compresses each to one cost plane; then
  MobileV2Residual blocks and three 2D hourglasses with the D/4 planes as
  channels, `classif3` and the same head.

The stride-1 MobileV2 blocks (the trunk's, and MSNet2D's 2D ones) run the
CUDA kernel K2 with `use_kernels` on. The JAX model's `impl3d="native"`
pins only pick a TPU lowering and have no counterpart here.

Attribute names follow the reference OpenStereo MSNet state_dicts, as
`openstereo_tpu/utils/torch_convert.py:convert_msnet2d` / `convert_msnet3d`
read them: `feature_extraction.{firstconv,layer1..4}`, `preconv11`,
`conv3d`, `volume11`, `dres0`, `dres1`, `encoder_decoder1..3`,
`classif0..3` (the eval path runs `classif3`; the others are kept for the
training heads and for loading reference checkpoints).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import build_gwc_volume, disparity_regression, gwc_volume, resize_trilinear
from ..layers import (MobileV1Residual, MobileV2Residual3D, MobileV2ResidualSeq, conv_norm,
                      convbn, deconv_bn, head_dtype, run_seq, siamese)


class MobileFeatureTrunk(nn.Module):
    """MobileV2 stem (strides 2, 1, 1; ReLUs between them with `add_relus`,
    as MSNet2D's reference) + MobileV1 stages → concat(l2, l3, l4), 320
    channels at 1/4 (`msnet.py:42-69`)."""

    def __init__(self, add_relus: bool = False):
        super().__init__()
        stem = []
        for i, s in enumerate((2, 1, 1)):
            stem.append(MobileV2ResidualSeq(3 if i == 0 else 32, 32, s, 3))
            if add_relus:
                stem.append(nn.ReLU())
        self.firstconv = nn.Sequential(*stem)
        self.layer1 = nn.Sequential(*[MobileV1Residual(32, 32) for _ in range(3)])
        self.layer2 = nn.Sequential(MobileV1Residual(32, 64, 2),
                                    *[MobileV1Residual(64, 64) for _ in range(15)])
        self.layer3 = nn.Sequential(MobileV1Residual(64, 128),
                                    *[MobileV1Residual(128, 128) for _ in range(2)])
        self.layer4 = nn.Sequential(*[MobileV1Residual(128, 128, dilation=2) for _ in range(3)])

    def forward(self, x):
        l2 = run_seq(run_seq(run_seq(x, self.firstconv), self.layer1), self.layer2)
        l3 = run_seq(l2, self.layer3)
        return torch.cat([l2, l3, run_seq(l3, self.layer4)], dim=1)


class Hourglass(nn.Module):
    """MobileV2-residual hourglass (`msnet.py:72-119`), 2D (MSNet2D, blocks
    `MobileV2ResidualSeq`) or 3D (MSNet3D, `MobileV2Residual3D`), expanse
    ratio 2, k3 s2 deconvs with BatchNorm. Keys conv1..conv6, redir1, redir2."""

    def __init__(self, c: int, ndim: int):
        super().__init__()
        mv2 = MobileV2ResidualSeq if ndim == 2 else MobileV2Residual3D
        self.conv1 = mv2(c, 2 * c, 2, 2)
        self.conv2 = mv2(2 * c, 2 * c, 1, 2)
        self.conv3 = mv2(2 * c, 4 * c, 2, 2)
        self.conv4 = mv2(4 * c, 4 * c, 1, 2)
        self.conv5 = deconv_bn(4 * c, 2 * c, 3, "batch", ndim)
        self.conv6 = deconv_bn(2 * c, c, 3, "batch", ndim)
        self.redir2 = mv2(2 * c, 2 * c, 1, 2)
        self.redir1 = mv2(c, c, 1, 2)

    def forward(self, x):
        conv2 = self.conv2(self.conv1(x))
        conv4 = self.conv4(self.conv3(conv2))
        conv5 = torch.relu(run_seq(conv4, self.conv5) + self.redir2(conv2))
        return torch.relu(run_seq(conv5, self.conv6) + self.redir1(x))


def classifier(c: int, out_ch: int, ndim: int) -> nn.Sequential:
    conv = nn.Conv2d if ndim == 2 else nn.Conv3d
    return nn.Sequential(convbn(c, c, 3, ndim=ndim), nn.ReLU(),
                         conv(c, out_ch, 3, padding=1, bias=False))


def regress(cost: torch.Tensor, max_disp: int, size) -> torch.Tensor:
    """[B,D/4,H/4,W/4] costs (head dtype) → trilinear to [B,D,H,W], softmax
    over D, soft-argmax → [B,H,W] (`msnet.py:165-168`, `:300-303`)."""
    cost = resize_trilinear(cost[:, None], (max_disp, *size))[:, 0]
    return disparity_regression(torch.softmax(cost, dim=1), max_disp)


class MSNet3D(nn.Module):
    """forward(data) → {'disp_pred': [B,H,W]} (eval; `msnet.py:122-179`).

    data['left'] / data['right']: [B,3,H,W] normalized images, H and W
    multiples of 16. `dtype` is the compute dtype (bf16 on the main path);
    parameters stay f32 and the head runs in at least f32.
    """

    use_kernels = True

    def __init__(self, max_disp: int = 192, num_groups: int = 40, hourglass_size: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.max_disp, self.num_groups, self.dtype = max_disp, num_groups, dtype
        c = hourglass_size
        self.feature_extraction = MobileFeatureTrunk()
        self.dres0 = nn.Sequential(MobileV2Residual3D(num_groups, c, 1, 3),
                                   MobileV2Residual3D(c, c, 1, 3))
        self.dres1 = nn.Sequential(MobileV2Residual3D(c, c, 1, 3), MobileV2Residual3D(c, c, 1, 3))
        for i in (1, 2, 3):
            setattr(self, f"encoder_decoder{i}", Hourglass(c, 3))
        for j in range(4):
            setattr(self, f"classif{j}", classifier(c, 1, 3))

    def forward(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self.training:
            raise NotImplementedError("MSNet3D training is ROADMAP item 8")
        left = data["left"].to(self.dtype)
        feat_l, feat_r = siamese(self.feature_extraction, left, data["right"].to(self.dtype))
        gwc = gwc_volume if self.use_kernels else build_gwc_volume
        volume = gwc(feat_l.contiguous(), feat_r.contiguous(), self.max_disp // 4,
                     self.num_groups)
        cost0 = run_seq(volume, self.dres0)
        cost0 = run_seq(cost0, self.dres1) + cost0
        out = cost0
        for i in (1, 2, 3):
            out = getattr(self, f"encoder_decoder{i}")(out)
        cost = run_seq(out, self.classif3)[:, 0]  # [B,D/4,H/4,W/4]
        return {"disp_pred": regress(cost.to(head_dtype(self.dtype)), self.max_disp,
                                     left.shape[-2:])}


def compressor_layers() -> Dict[str, nn.Sequential]:
    """MSNet2D's interlaced compressor (`msnet.py:190-221`): `conv3d`, three
    3D convs with bias over [N,1,64,H,W] (kernel (k,3,3), stride (k,1,1),
    padding (0,1,1), k = 8, 4, 2), each with BN and ReLU; `volume11`, a 1×1
    convbn to one channel and a ReLU."""
    stages = []
    for cin, cout, k in ((1, 16, 8), (16, 32, 4), (32, 16, 2)):
        stages += conv_norm(cin, cout, (k, 3, 3), (k, 1, 1), (0, 1, 1), bias=True,
                            norm="batch", ndim=3) + [nn.ReLU()]
    return {"conv3d": nn.Sequential(*stages),
            "volume11": nn.Sequential(convbn(16, 1, 1), nn.ReLU())}


def interlaced_compress(conv3d: nn.Sequential, volume11: nn.Sequential,
                        interleaved: torch.Tensor, col_valid: torch.Tensor) -> torch.Tensor:
    """[N,64,H,W] interleaved descriptors, [N,W] column validity → [N,H,W].

    The reference computes each shift on the width-cropped valid columns, so
    every stage sees zeros beyond the crop; on the full width the invalid
    columns are zeroed again after every stage, as bias and BN make them
    non-zero (`msnet.py:197-217`)."""
    keep = col_valid[:, None, None, None, :]
    x = interleaved.masked_fill(~col_valid[:, None, None, :], 0)[:, None]  # [N,1,64,H,W]
    for i in range(0, len(conv3d), 3):
        x = run_seq(x, conv3d[i:i + 3]).masked_fill(~keep, 0)
    return run_seq(x[:, :, 0], volume11)[:, 0]


class MSNet2D(nn.Module):
    """forward(data) → {'disp_pred': [B,H,W]} (eval; `msnet.py:224-313`).

    As MSNet3D; the volume is interlaced (module docstring).
    """

    def __init__(self, max_disp: int = 192, hg_size: int = 48,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.max_disp, self.dtype = max_disp, dtype
        c, d4 = hg_size, max_disp // 4
        self.feature_extraction = MobileFeatureTrunk(add_relus=True)
        self.preconv11 = nn.Sequential(convbn(320, 256, 1), nn.ReLU(), convbn(256, 128, 1),
                                       nn.ReLU(), convbn(128, 64, 1), nn.ReLU(),
                                       nn.Conv2d(64, 32, 1))
        for name, seq in compressor_layers().items():
            setattr(self, name, seq)
        self.dres0 = nn.Sequential(MobileV2ResidualSeq(d4, c, 1, 3), nn.ReLU(),
                                   MobileV2ResidualSeq(c, c, 1, 3), nn.ReLU())
        self.dres1 = nn.Sequential(MobileV2ResidualSeq(c, c, 1, 3), nn.ReLU(),
                                   MobileV2ResidualSeq(c, c, 1, 3))
        for i in (1, 2, 3):
            setattr(self, f"encoder_decoder{i}", Hourglass(c, 2))
        for j in range(4):
            setattr(self, f"classif{j}", classifier(c, c, 2))

    def interlaced_volume(self, feat_l: torch.Tensor, feat_r: torch.Tensor) -> torch.Tensor:
        """320-channel features ×2 → [B,D/4,H/4,W/4] (`msnet.py:245-278`):
        every shift through the compressor as one batch of D/4·B, shift-major;
        entries out of frame (w < d) zero."""
        fl, fr = run_seq(feat_l, self.preconv11), run_seq(feat_r, self.preconv11)
        b, c, h4, w4 = fl.shape
        d4 = self.max_disp // 4
        stacked = torch.cat([torch.stack([fl, F.pad(fr[..., :w4 - d], (d, 0))], dim=2)
                             .reshape(b, 2 * c, h4, w4) for d in range(d4)])
        cols = torch.arange(w4, device=fl.device)
        shifts = torch.arange(d4, device=fl.device)
        col_valid = cols[None, :] >= shifts.repeat_interleave(b)[:, None]  # [D/4·B, W/4]
        planes = interlaced_compress(self.conv3d, self.volume11, stacked, col_valid)
        volume = planes.reshape(d4, b, h4, w4)
        volume = volume.masked_fill(cols[None, None, None, :] < shifts[:, None, None, None], 0)
        return volume.transpose(0, 1)

    def forward(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self.training:
            raise NotImplementedError("MSNet2D training is ROADMAP item 8")
        left = data["left"].to(self.dtype)
        feat_l, feat_r = siamese(self.feature_extraction, left, data["right"].to(self.dtype))
        volume = self.interlaced_volume(feat_l, feat_r).contiguous()
        cost0 = run_seq(volume, self.dres0)
        cost0 = run_seq(cost0, self.dres1) + cost0
        out = cost0
        for i in (1, 2, 3):
            out = getattr(self, f"encoder_decoder{i}")(out)
        cost = run_seq(out, self.classif3)  # [B,D/4,H/4,W/4]
        return {"disp_pred": regress(cost.to(head_dtype(self.dtype)), self.max_disp,
                                     left.shape[-2:])}
