"""FastFoundationStereo, NCHW / NCDHW (counterpart of
`openstereo_tpu/models/fastfoundationstereo/fastfoundationstereo.py:50-228`).

FoundationStereo's volume, AHCF filtering, selective GRU and superpixel
upsample (`foundationstereo.FSFamily`), with the frozen ViT gone: the
EdgeNeXt trunk and its Conv2x_IN decoder alone, widened at 1/4 by a 1×1
conv to FoundationStereo's channel budget (96 + 128 at VIT_SIZE vitl); a
shared 3×3 context head at 1/4; one GRU scale (N_GRU_LAYERS 1), its motion
encoder fusing with a 1×1 conv; and the disparity transformer's
`headwise` attention (`blocks.DispTransformerLayer`). The cosine volume goes
through K3 with divisor 1 on the card in eval. Training (TRAIN_ITERS
iterations, both views one after the other, the outputs and the loss) is
FoundationStereo's (`FSFamily`).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from ..backbones.edgenext import EdgeNeXtFeatures
from ..foundationstereo.blocks import Conv2xFS
from ..foundationstereo.foundationstereo import FSFamily, vit_feat_dim
from ..layers import run_conv, run_seq


class FFSFeature(EdgeNeXtFeatures):
    """EdgeNeXt trunk + Conv2x_IN decoder + the 1×1 widening conv4
    (`fastfoundationstereo.py:50-72`): [B,3,H,W] → [y4 (96 + vit channels),
    y8, y16, c32], in the caller's compute `dtype`. Keys: stem, stages,
    deconv32_16, deconv16_8, deconv8_4, conv4."""

    def __init__(self, vit_size: str = "vitl"):
        super().__init__()
        self.deconv32_16 = Conv2xFS(304, 160)
        self.deconv16_8 = Conv2xFS(320, 96)
        self.deconv8_4 = Conv2xFS(192, 48)
        self.conv4 = nn.Conv2d(96, 96 + vit_feat_dim(vit_size), 1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype):
        c4, c8, c16, c32 = self.trunk(x.to(dtype))
        y16 = self.deconv32_16(c32, c16)
        y8 = self.deconv16_8(y16, c8)
        y4 = run_conv(self.deconv8_4(y8, c4), self.conv4)
        return [y4, y8, y16, c32]


class SharedContextNet(nn.Module):
    """The 3×3 hidden-state and input heads at 1/4 (`fastfoundationstereo.py:75-89`).
    Keys: conv04.{0,1}."""

    def __init__(self, cin: int, hidden_dim: int = 128):
        super().__init__()
        self.conv04 = nn.ModuleList(nn.Conv2d(cin, hidden_dim, 3, padding=1) for _ in range(2))

    def forward(self, x4: torch.Tensor):
        return [(run_conv(x4, self.conv04[0]), run_conv(x4, self.conv04[1]))]


class FastFoundationStereo(FSFamily):
    """forward(data) → {'disp_pred': [B,H,W]}, in training also 'init_disp'
    and 'disp_preds' (TRAIN_ITERS of [B,H,W]); data as
    `FoundationStereo` takes it (ImageNet-normalised, H and W multiples of
    32). Keys follow the reference FastFoundationStereo state_dict as
    `convert_fastfoundationstereo` reads it, without `context_zqr_convs`
    and the lookup-offset buffer `dx` (`REFERENCE_ONLY_KEYS`)."""

    REFERENCE_ONLY_KEYS = ("context_zqr_convs.", "dx")

    def __init__(self, max_disp: int = 192, vit_size: str = "vitl", hidden_dim: int = 128,
                 volume_dim: int = 28, concat_channels: int = 24, n_gru_layers: int = 1,
                 corr_levels: int = 2, corr_radius: int = 4, train_iters: int = 12,
                 valid_iters: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.max_disp, self.vit_size, self.dtype = max_disp, vit_size, dtype
        self.hidden_dim, self.volume_dim, self.n_gru_layers = hidden_dim, volume_dim, n_gru_layers
        self.corr_levels, self.corr_radius = corr_levels, corr_radius
        self.train_iters, self.valid_iters = train_iters, valid_iters
        self.motion_fuse_kernel = 1  # fast update.py:33 fuses with a 1×1 conv
        c4 = 96 + vit_feat_dim(vit_size)
        self.feature = FFSFeature(vit_size)
        self._volume_modules(c4, (c4, 192, 320, 304), concat_channels, headwise=True)
        self.cnet = SharedContextNet(c4, hidden_dim)

    def forward(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        left, right = self.images(data)
        feats_l, feats_r = self.features(left, right)
        stem_2x = run_seq(left.to(self.dtype), self.stem_2)
        comb, init_disp = self.filtered(feats_l, feats_r)
        iterates = self.refine(self.cnet(feats_l[0]), feats_l, feats_r, comb, init_disp)
        return self.outputs(iterates, stem_2x, init_disp)
