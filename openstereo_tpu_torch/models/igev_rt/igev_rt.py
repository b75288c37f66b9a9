"""IGEV-RT, NCHW / NCDHW (counterpart of `openstereo_tpu/models/igev_rt/igev_rt.py`).

IGEV's trunk, stems and descriptors (`models/igev`), then:
- the group-wise volume (8 groups, D/4 planes) through K3, straight into
  `GeoHourglass(8)`: no corr_stem and no feature attention on the volume
  (`igev_rt.py:160-164`);
- the initial disparity by soft-argmax over the classified planes;
- a conv-only hidden state (`hnet`: BasicConvBN, then a bias-free 3×3
  conv; tanh) and context (`cnet`: BasicConvBN, then `context_zqr_conv`,
  split in three) over the 1/4 features (`:171-181`);
- VALID_ITERS (eval) or TRAIN_ITERS (training) iterations of one ConvGRU
  at 1/4, each sampling only the geometry pyramid (`:183-189`): cor_planes
  = levels·(2r+1)·8; the loop, the upsampling and the training heads are
  IGEV's (`IGEVFamily`);
- the loss: smooth-L1 on the upsampled initial disparity plus the
  γ-weighted L1 over the iterates, over 0 < gt < min(max_disp, 192)
  (`:249-260`: the reference gates at 192 whatever MAX_DISP).

Images arrive as the config gives them and are not rescaled inside (IGEV's
[0,255] → [-1,1] is not copied). The trunk runs K2 in eval, K3 builds the
volume in eval; training runs their plain versions (IGEV's rules).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import run_conv, run_seq
from ..igev.blocks import BasicConvBN, BasicConvIN, Conv2x, Feature
from ..igev.geometry import MultiLookup, avg_pool_last, lookup_dtype
from ..igev.igev import FEATURE_CHANNELS, GeoHourglass, IGEVFamily, sequence_loss, stem
from ..igev.update import BasicMotionEncoder, ConvGRU, DispHead
from ..losses import masked_smooth_l1


class BasicUpdateBlock(nn.Module):
    """One ConvGRU at 1/4 (`igev_rt.py:61-76`): net, (cz, cr, cq), geometry
    taps, disp → (net, mask_feat_4, Δdisp); its motion encoder convs to 95
    channels, then appends the disparity (`RTMotionEncoder`, `:43-58`). Keys:
    encoder, gru, disp_head, mask_feat_4.0."""

    def __init__(self, hidden_dim: int = 96, cor_planes: int = 144):
        super().__init__()
        self.encoder = BasicMotionEncoder(cor_planes, out=96)
        self.gru = ConvGRU(hidden_dim, 96)
        self.disp_head = DispHead(hidden_dim, 128)
        self.mask_feat_4 = nn.Sequential(nn.Conv2d(hidden_dim, 32, 3, padding=1), nn.ReLU())

    def forward(self, net, context, geo, disp):
        net = self.gru(net, context, self.encoder(disp, geo))
        delta_disp = self.disp_head(net)
        mask_feat_4 = F.relu(run_conv(net, self.mask_feat_4[0]))
        return net, mask_feat_4, delta_disp


class IGEVRT(IGEVFamily):
    """forward(data) → {'disp_pred': [B,H,W]}, in training also 'init_disp'
    and 'disp_preds' (TRAIN_ITERS of them).

    data['left'] / data['right']: [B,3,H,W], H and W multiples of 32. Dtypes
    as IGEV's: parameters f32, heads in at least f32, the carried disparity
    f32, the pyramid in `lookup_dtype`. Keys follow the reference
    IGEVRTStereo state_dict.
    """

    GROUPS = 8

    def __init__(self, max_disp: int = 192, hidden_dim: int = 96, corr_levels: int = 2,
                 corr_radius: int = 4, train_iters: int = 22, valid_iters: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.max_disp, self.dtype = max_disp, dtype
        self.hidden_dim, self.corr_levels, self.corr_radius = hidden_dim, corr_levels, corr_radius
        self.train_iters, self.valid_iters = train_iters, valid_iters
        c4 = FEATURE_CHANNELS[0]

        self.feature = Feature()
        self.stem_2 = stem(3, 32, 2)
        self.stem_4 = stem(32, 48, 2)
        self.spx_4 = stem(c4, 24, 1)
        self.spx_2 = Conv2x(24, 32, norm="instance")
        self.spx = nn.Sequential(nn.ConvTranspose2d(64, 9, 4, 2, 1))
        self.spx_2_gru = Conv2x(32, 32, norm="batch")
        self.spx_gru = nn.Sequential(nn.ConvTranspose2d(64, 9, 4, 2, 1))
        self.conv = BasicConvIN(c4, c4, 3, 1)
        self.desc = nn.Conv2d(c4, c4, 1)
        self.cost_agg = GeoHourglass(self.GROUPS)
        self.classifier = nn.Conv3d(self.GROUPS, 1, 3, 1, 1, bias=False)
        self.hnet = nn.Sequential(BasicConvBN(c4, hidden_dim, 3, 1),
                                  nn.Conv2d(hidden_dim, hidden_dim, 3, 1, 1, bias=False))
        self.cnet = BasicConvBN(c4, hidden_dim, 3, 1)
        self.context_zqr_conv = nn.Conv2d(hidden_dim, hidden_dim * 3, 3, padding=1)
        cor_planes = corr_levels * (2 * corr_radius + 1) * self.GROUPS
        self.update_block = BasicUpdateBlock(hidden_dim, cor_planes)

    def gru_iteration(self, net, context, geo_lookup, disp):
        """One iteration (`igev_rt.py:79-108`): disp [B,1,H,W] f32 → (net, the
        new disp, mask_feat_4)."""
        r = self.corr_radius
        dx = torch.arange(-r, r + 1, dtype=disp.dtype, device=disp.device)
        d0 = disp[:, 0, ..., None]
        geo = torch.cat(geo_lookup([d0 / (2.0 ** i) + dx for i in range(self.corr_levels)]),
                        dim=-1).permute(0, 3, 1, 2)
        net, mask_feat_4, delta = self.update_block(net, context, geo, disp)
        return net, disp + delta, mask_feat_4

    def forward(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        image1, image2 = data["left"].to(self.dtype), data["right"].to(self.dtype)
        feats_l, stem_2x, match_left, match_right = self.descriptors(image1, image2)
        d4 = self.max_disp // 4
        gwc = self.gwc(match_left, match_right, d4, self.GROUPS)  # [B,8,D/4,H/4,W/4]
        geo_volume = self.cost_agg(gwc, feats_l)
        init_disp = self.regress(geo_volume, d4)  # [B,H/4,W/4]

        net = torch.tanh(run_seq(feats_l[0], self.hnet))
        zqr = run_conv(self.cnet(feats_l[0]), self.context_zqr_conv)
        context = tuple(torch.chunk(zqr, 3, dim=1))

        geo = geo_volume.to(lookup_dtype(self.dtype)).permute(0, 3, 4, 1, 2).contiguous()
        pyramid = [geo]
        for _ in range(self.corr_levels - 1):
            pyramid.append(avg_pool_last(pyramid[-1]))
        iterates = self.refine(net, context, MultiLookup(pyramid), disp=init_disp)
        return self.outputs(iterates, stem_2x, feats_l[0], [init_disp])

    def get_loss(self, pred: Dict, data: Dict):
        """IGEV's sequence loss over 0 < gt < max_disp and gt < 192 (the
        reference's gate, whatever MAX_DISP; `igev_rt.py:249-260`)."""
        gt = data["disp"]
        mask = (gt < self.max_disp) & (gt > 0) & (gt < 192.0)
        loss = sequence_loss(masked_smooth_l1(pred["init_disp"], gt, mask), pred["disp_preds"],
                             gt, mask)
        return loss, {"loss_disp": loss}
