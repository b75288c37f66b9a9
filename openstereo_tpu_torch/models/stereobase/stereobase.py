"""StereoBase, NCHW / NCDHW (counterpart of `openstereo_tpu/models/stereobase/stereobase.py`).

IGEV's machinery (`models/igev`) under StereoBase's key spelling (its
reference builds the stems, the decoder's Conv2x, `conv`, the superpixel
heads and every hourglass conv from `BasicConv2d`/`3d`, a `.block`
Sequential: `torch_convert.py:convert_stereobase`), with:
- a fused cost volume, on the channel axis in this order: group-wise
  (NUM_GROUPS, through K3), concat (CONCAT_CHANNELS a side, from
  `concat_conv`), the L1 "sub" volume, and the interlaced volume
  (`InterlacedVolume`); each optional (`stereobase.py:179-201`);
- `GeoHourglass` over the fused volume's `volume_channels`;
- the initial disparity by soft-argmax, IGEV's context net and
  EVAL_ITERS (eval) or TRAIN_ITERS (training) iterations of IGEV's GRU
  cascade (slow-fast as SLOW_FAST_GRU), whose motion encoder reads
  levels·(2r+1)·(channels + 1) taps of the geometry and correlation
  pyramids; the loop, the upsampling and the training heads are IGEV's
  (`IGEVFamily`), and so is the loss (`stereobase.py:298-308`).

Images arrive normalised by the config's NormalizeImage and are not
rescaled inside. The trunk runs K2 in eval, K3 builds the group-wise
volume in eval; training runs their plain versions, each view through the
trunk, the stems and `concat_conv` on its own (each BatchNorm updated left,
then right), and the interlaced volume's BatchNorms on their batch
statistics.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import build_concat_volume, build_sub_volume
from ..layers import ConvBlock, conv_norm, run_seq
from ..igev.blocks import BasicConvIN, Conv2x, Feature, MultiBasicEncoder
from ..igev.geometry import CombinedGeoEncodingVolume, lookup_dtype
from ..igev.igev import (FEATURE_CHANNELS, GeoHourglass, IGEVFamily, init_sequence_loss,
                         pixel_columns, stem)
from ..igev.update import BasicMultiUpdateBlock
from ..msnet.msnet import masked_depth_stages


class _Conv3dBlock(nn.Module):
    """A 3D conv (bias-free, explicit padding) + BatchNorm + ReLU as `block`
    (keys block.0, block.1), which `InterlacedVolume` runs stage by stage."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size, stride, padding):
        super().__init__()
        self.block = nn.Sequential(*conv_norm(in_ch, out_ch, kernel_size, stride, padding,
                                              norm="batch", ndim=3), nn.ReLU())


class InterlacedVolume(nn.Module):
    """Per disparity shift, the left and the shifted right descriptors
    interleaved channel by channel (2C "depth" planes), compressed by a
    shared strided 3D conv stack to one plane of 16 channels and a 1×1
    convbn to `num_features` (`stereobase.py:55-98`); every shift as one batch
    of D·B, the columns out of frame (w < d) zeroed after every stage
    (`msnet.masked_depth_stages`). The stack's depth strides assume 2C = 192.
    Keys: conv3d.{0,1,2}.block.{0,1}, volume11.block.{0,1}."""

    def __init__(self, num_features: int = 8):
        super().__init__()
        self.conv3d = nn.ModuleList(_Conv3dBlock(cin, cout, (k, 3, 3), (k, 1, 1), (0, 1, 1))
                                    for cin, cout, k in ((1, 16, 8), (16, 32, 8), (32, 16, 3)))
        self.volume11 = ConvBlock(16, num_features, 1, norm="batch", act=F.relu)

    def forward(self, feat_l: torch.Tensor, feat_r: torch.Tensor, max_disp: int) -> torch.Tensor:
        """[B,C,H,W] ×2 → [B,F,D,H,W]."""
        b, c, h, w = feat_l.shape
        stacked = torch.cat([torch.stack([feat_l, F.pad(feat_r[..., :max(w - d, 0)],
                                                         (min(d, w), 0))], dim=2)
                             .reshape(b, 2 * c, h, w) for d in range(max_disp)])
        cols = torch.arange(w, device=feat_l.device)
        shifts = torch.arange(max_disp, device=feat_l.device)
        col_valid = cols[None, :] >= shifts.repeat_interleave(b)[:, None]  # [D·B, W]
        planes = masked_depth_stages([m.block for m in self.conv3d], stacked, col_valid)
        planes = self.volume11(planes).masked_fill(~col_valid[:, None, None, :], 0)  # [D·B,F,H,W]
        return planes.reshape(max_disp, b, -1, h, w).permute(1, 2, 0, 3, 4)


class StereoBase(IGEVFamily):
    """forward(data) → {'disp_pred': [B,H,W]}, in training also 'init_disp'
    and 'disp_preds' (TRAIN_ITERS of them).

    data['left'] / data['right']: [B,3,H,W] normalised images, H and W
    multiples of 32. Dtypes as IGEV's. Keys follow the reference StereoBase
    state_dict (`concat_conv` and `build_interlaced_volume` only when their
    volume is on).
    """

    def __init__(self, max_disp: int = 192, num_groups: int = 8, use_gwc_volume: bool = True,
                 use_concat_volume: bool = False, use_sub_volume: bool = False,
                 use_interlaced_volume: bool = False, concat_channels: int = 12,
                 interlaced_channels: int = 8, hidden_dims: Sequence[int] = (128, 128, 128),
                 n_gru_layers: int = 3, n_downsample: int = 2, slow_fast_gru: bool = False,
                 corr_levels: int = 2, corr_radius: int = 4, train_iters: int = 22,
                 eval_iters: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        if n_downsample != 2:
            raise NotImplementedError(f"StereoBase n_downsample {n_downsample}: the port takes "
                                      "2, as every config sets (the upsampling is ×4)")
        self.max_disp, self.num_groups, self.dtype = max_disp, num_groups, dtype
        self.use_gwc_volume, self.use_concat_volume = use_gwc_volume, use_concat_volume
        self.use_sub_volume, self.use_interlaced_volume = use_sub_volume, use_interlaced_volume
        self.concat_channels, self.interlaced_channels = concat_channels, interlaced_channels
        self.hidden_dims = tuple(hidden_dims)
        self.n_gru_layers, self.slow_fast_gru = n_gru_layers, slow_fast_gru
        self.corr_levels, self.corr_radius = corr_levels, corr_radius
        self.train_iters, self.eval_iters = train_iters, eval_iters
        hd = list(hidden_dims)
        c4 = FEATURE_CHANNELS[0]
        vc = self.volume_channels
        if vc == 0:
            raise ValueError("StereoBase: no cost volume is on")

        self.feature = Feature(spelling="block")
        self.stem_2 = stem(3, 32, 2, spelling="block")
        self.stem_4 = stem(32, 48, 2, spelling="block")
        self.spx_4 = stem(c4, 24, 1, spelling="block")
        self.spx_2 = Conv2x(24, 32, norm="instance", spelling="block")
        self.spx = nn.Sequential(nn.ConvTranspose2d(64, 9, 4, 2, 1))
        self.spx_2_gru = Conv2x(32, 32, norm="batch", spelling="block")
        self.spx_gru = nn.Sequential(nn.ConvTranspose2d(64, 9, 4, 2, 1))
        self.conv = BasicConvIN(c4, c4, 3, 1, spelling="block")
        self.desc = nn.Conv2d(c4, c4, 1)
        if use_concat_volume:
            self.concat_conv = nn.Sequential(
                ConvBlock(c4, 32, 3, norm="batch", act=F.relu),
                nn.Conv2d(32, concat_channels, 1, bias=False))
        if use_interlaced_volume:
            self.build_interlaced_volume = InterlacedVolume(interlaced_channels)
        self.cost_agg = GeoHourglass(vc, spelling="block")
        self.classifier = nn.Conv3d(vc, 1, 3, 1, 1, bias=False)
        self.cnet = MultiBasicEncoder([hd, hd])
        self.context_zqr_convs = nn.ModuleList(nn.Conv2d(hd[i], hd[i] * 3, 3, padding=1)
                                               for i in range(3))
        cor_planes = corr_levels * (2 * corr_radius + 1) * (vc + 1)
        self.update_block = BasicMultiUpdateBlock(hd[::-1], n_gru_layers, cor_planes)

    @property
    def valid_iters(self) -> int:
        """EVAL_ITERS, under the name `IGEVFamily.iters` reads."""
        return self.eval_iters

    @property
    def volume_channels(self) -> int:
        """The fused volume's channels (`stereobase.py:129`)."""
        return (self.num_groups * self.use_gwc_volume
                + 2 * self.concat_channels * self.use_concat_volume
                + self.use_sub_volume + self.interlaced_channels * self.use_interlaced_volume)

    def cost_volume(self, match_left: torch.Tensor, match_right: torch.Tensor) -> torch.Tensor:
        """The fused volume [B,volume_channels,D/4,H/4,W/4]: gwc, concat, sub,
        interlaced, in that order (`stereobase.py:179-201`)."""
        d4 = self.max_disp // 4
        volumes = []
        if self.use_gwc_volume:
            volumes.append(self.gwc(match_left, match_right, d4, self.num_groups))
        if self.use_concat_volume:
            volumes.append(build_concat_volume(run_seq(match_left, self.concat_conv),
                                               run_seq(match_right, self.concat_conv), d4))
        if self.use_sub_volume:
            volumes.append(build_sub_volume(match_left, match_right, d4)[:, None])
        if self.use_interlaced_volume:
            volumes.append(self.build_interlaced_volume(match_left, match_right, d4))
        return volumes[0] if len(volumes) == 1 else torch.cat(volumes, dim=1)

    def forward(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        image1, image2 = data["left"].to(self.dtype), data["right"].to(self.dtype)
        feats_l, stem_2x, match_left, match_right = self.descriptors(image1, image2)
        geo_volume = self.cost_agg(self.cost_volume(match_left, match_right), feats_l)
        init_disp = self.regress(geo_volume, self.max_disp // 4)  # [B,H/4,W/4]
        net, inp = self.context(image1)
        ld = lookup_dtype(self.dtype)
        geo_fn = CombinedGeoEncodingVolume(match_left.to(ld), match_right.to(ld),
                                           geo_volume.to(ld), self.corr_levels, self.corr_radius)
        iterates = self.refine(net, inp, geo_fn, pixel_columns(init_disp), disp=init_disp)
        return self.outputs(iterates, stem_2x, feats_l[0], [init_disp])

    def get_loss(self, pred: Dict, data: Dict):
        """IGEV's sequence loss over 0 < gt < max_disp (`stereobase.py:298-308`)."""
        return init_sequence_loss(pred, data, self.max_disp)
