"""DPT head and DepthAnythingV2, NCHW (counterpart of
`openstereo_tpu/models/backbones/dpt.py:30-208`).

The head reassembles four ViT tap layers into a pyramid (1×1 projections;
×4 and ×2 transposed convs, identity, a symmetric-pad stride-2 conv), fuses
it coarse to fine with RefineNet blocks (align-corners bilinear resizes)
and returns the `features // 2`-channel map after `output_conv1`, resized
(align corners) to the full ViT input: what FoundationStereo concatenates
into its 1/4 features. The relative-depth branch (`output_conv2`) runs only
when asked; its parameters exist for the state_dict's round trip. Keys
follow the reference DPTHead as `openstereo_tpu/utils/torch_convert.py:_dpt_head`
reads them; refinenet4's `resConfUnit1`, which the reference holds and never
runs, is not held (FoundationStereo's and MonSter's `REFERENCE_ONLY_KEYS`
skip it).

`DPTPyramidDecoder` (MonSter's trainable `feat_decoder`) reassembles the
same taps and returns the four fusion paths, each refinenet at its own
level's resolution, instead of a full-resolution feature.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import resize_linear_align_corners
from ..layers import run_conv
from .dinov2 import PATCH, VIT_CONFIGS, DinoViT

DAV2_CONFIGS = {
    # encoder: (features, out_channels) (`dpt.py:30-35`)
    "vits": (64, (48, 96, 192, 384)),
    "vitb": (128, (96, 192, 384, 768)),
    "vitl": (256, (256, 512, 1024, 1024)),
}


class ResidualConvUnit(nn.Module):
    """relu-conv ×2 with a skip (`dpt.py:38-52`). Keys: conv1, conv2."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = run_conv(F.relu(x), self.conv1)
        return x + run_conv(F.relu(y), self.conv2)


class FeatureFusionBlock(nn.Module):
    """RefineNet fusion (`dpt.py:55-71`): plus resConfUnit1 of the skip (where
    one is given), resConfUnit2, an align-corners resize ×2 (or to `out_hw`),
    the 1×1 out_conv. Keys: resConfUnit1 (with `skip`), resConfUnit2, out_conv."""

    def __init__(self, features: int, skip: bool = True):
        super().__init__()
        if skip:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None,
                out_hw: Optional[Sequence[int]] = None) -> torch.Tensor:
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        out_hw = tuple(out_hw) if out_hw is not None else (x.shape[2] * 2, x.shape[3] * 2)
        return run_conv(resize_linear_align_corners(x, out_hw), self.out_conv)


class Scratch(nn.Module):
    """The reference's `scratch`: layer{1..4}_rn, refinenet{1..4} and, with
    `outputs`, output_conv1, output_conv2 (conv, relu, conv, relu)."""

    def __init__(self, features: int, out_channels: Sequence[int], outputs: bool = True):
        super().__init__()
        for i, oc in enumerate(out_channels):
            setattr(self, f"layer{i + 1}_rn", nn.Conv2d(oc, features, 3, padding=1, bias=False))
        for k in range(1, 5):
            setattr(self, f"refinenet{k}", FeatureFusionBlock(features, skip=k != 4))
        if outputs:
            self.output_conv1 = nn.Conv2d(features, features // 2, 3, padding=1)
            self.output_conv2 = nn.Sequential(nn.Conv2d(features // 2, 32, 3, padding=1),
                                              nn.ReLU(), nn.Conv2d(32, 1, 1), nn.ReLU())


class Reassemble(nn.Module):
    """The four ViT taps → the DPT pyramid at 4×, 2×, 1× and ½× the patch grid,
    `features` wide: 1×1 projections, ×4 and ×2 transposed convs, identity,
    a symmetric-pad stride-2 conv (`dpt.py:89-107`), then scratch.layer{i}_rn.
    Keys: projects.i, resize_layers.{0,1,3}, scratch.*."""

    def __init__(self, in_dim: int, features: int, out_channels: Sequence[int], outputs: bool):
        super().__init__()
        oc = list(out_channels)
        self.projects = nn.ModuleList(nn.Conv2d(in_dim, c, 1) for c in oc)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, 4), nn.ConvTranspose2d(oc[1], oc[1], 2, 2),
            nn.Identity(), nn.Conv2d(oc[3], oc[3], 3, 2, 1)])
        self.scratch = Scratch(features, oc, outputs)

    def levels(self, taps: List[Tuple[torch.Tensor, torch.Tensor]], patch_h: int,
               patch_w: int) -> List[torch.Tensor]:
        out = []
        for i, (tok, _cls) in enumerate(taps):
            x = tok.transpose(1, 2).reshape(tok.shape[0], tok.shape[2], patch_h, patch_w)
            x = run_conv(x, self.projects[i])
            if i != 2:
                x = run_conv(x, self.resize_layers[i])
            out.append(run_conv(x, getattr(self.scratch, f"layer{i + 1}_rn")))
        return out


class DPTHead(Reassemble):
    """ViT taps → fused pyramid → (feat [B, features/2, 14·ph, 14·pw], depth
    [B, 14·ph, 14·pw] or None) (`dpt.py:74-132`). Keys: projects.i,
    resize_layers.{0,1,3}, scratch.*."""

    def __init__(self, in_dim: int, features: int = 64,
                 out_channels: Sequence[int] = (48, 96, 192, 384)):
        super().__init__(in_dim, features, out_channels, outputs=True)

    def forward(self, taps: List[Tuple[torch.Tensor, torch.Tensor]], patch_h: int, patch_w: int,
                depth: bool = False):
        l1, l2, l3, l4 = self.levels(taps, patch_h, patch_w)
        s = self.scratch
        p = s.refinenet4(l4, out_hw=l3.shape[2:])
        p = s.refinenet3(p, l3, out_hw=l2.shape[2:])
        p = s.refinenet2(p, l2, out_hw=l1.shape[2:])
        p = s.refinenet1(p, l1)
        # the reference returns the feature after the align-corners resize to the full
        # ViT input (`dpt.py:121-127`)
        up = resize_linear_align_corners(run_conv(p, s.output_conv1),
                                         (patch_h * PATCH, patch_w * PATCH))
        if not depth:
            return up, None
        d = run_conv(F.relu(run_conv(up, s.output_conv2[0])), s.output_conv2[2])
        return up, F.relu(d[:, 0])


class DPTPyramidDecoder(Reassemble):
    """ViT taps → the four fusion paths [p1 @4×, p2 @2×, p3 @1×, p4 @½× the patch
    grid], each `features` wide (`dpt.py:135-181`): each refinenet runs at its
    own level's resolution (its resize to the same size is the identity), the
    coarser path resized to the finer level (align corners) before it is
    fused there; refinenet4 takes l4 alone. Keys as `DPTHead`'s without the
    output convs."""

    def __init__(self, in_dim: int, features: int = 64,
                 out_channels: Sequence[int] = (48, 96, 192, 384)):
        super().__init__(in_dim, features, out_channels, outputs=False)

    def forward(self, taps: List[Tuple[torch.Tensor, torch.Tensor]], patch_h: int,
                patch_w: int) -> List[torch.Tensor]:
        l1, l2, l3, l4 = self.levels(taps, patch_h, patch_w)
        s = self.scratch
        p4 = s.refinenet4(l4, out_hw=l4.shape[2:])
        p3 = s.refinenet3(resize_linear_align_corners(p4, l3.shape[2:]), l3, out_hw=l3.shape[2:])
        p2 = s.refinenet2(resize_linear_align_corners(p3, l2.shape[2:]), l2, out_hw=l2.shape[2:])
        p1 = s.refinenet1(resize_linear_align_corners(p2, l1.shape[2:]), l1, out_hw=l1.shape[2:])
        return [p1, p2, p3, p4]


class DepthAnythingV2(nn.Module):
    """DINOv2 trunk + DPT head (`dpt.py:188-208`): images [B,3,H,W], H and W
    multiples of 14 → (feat, depth or None) as `DPTHead`. Keys: pretrained,
    depth_head."""

    def __init__(self, encoder: str = "vits"):
        super().__init__()
        feats, out_ch = DAV2_CONFIGS[encoder]
        self.pretrained = DinoViT(encoder)
        self.depth_head = DPTHead(VIT_CONFIGS[encoder][0], feats, out_ch)

    def forward(self, x: torch.Tensor, depth: bool = False):
        return self.depth_head(self.pretrained(x), x.shape[2] // PATCH, x.shape[3] // PATCH,
                               depth)
