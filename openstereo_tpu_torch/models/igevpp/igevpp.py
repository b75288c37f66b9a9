"""IGEV++, NCHW / NCDHW (counterpart of `openstereo_tpu/models/igevpp/igevpp.py`).

IGEV's trunk, stems, descriptors and context net (`models/igev`), then:
- one group-wise volume over all MAX_DISP/4 planes through K3, and three
  ranges carved from it (`igevpp.py:279-290`): the first S planes as they
  are, the first M planes pooled 2× in depth by `patch0` (a bias-free
  (2,1,1) stride-2 conv), all planes pooled 4× by `patch1` ((4,1,1),
  stride 4);
- each range through its own InstanceNorm hourglass (`PPHourglass`) and
  the shared classifier, regressed at its own interval (`:301-307`);
- the selective-fusion weights, a sigmoid of 3 channels from the 1/4
  features and the three disparities (`:309-321`);
- VALID_ITERS (eval) or TRAIN_ITERS (training) iterations of the
  three-scale GRU cascade (`PPUpdateBlock`, no slow-fast updates), each
  sampling the small range's two-level pyramid, the medium and large ranges
  at d/2 and d/4 (one merged lookup, each tap valid only in its own segment)
  and the all-pairs correlation at `coords − d` (`:174-215`); the loop and
  the upsampling are IGEV's (`IGEVFamily`), `spx_2_gru` with InstanceNorm;
- in training the three range disparities upsampled ×4 by the one shared
  set of training heads (`:400-413`), and the loss: their smooth-L1 weighted
  1.0, 0.5 and 0.2, each over 0 < gt < max_disp below its own cap
  (DISP_CAPS), plus the γ-weighted L1 over the iterates below the last cap
  (`:416-432`).

Images arrive as the config gives them and are not rescaled inside. The
trunk runs K2 in eval, K3 builds the volume in eval; training runs their
plain versions (IGEV's rules).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import run_conv, run_seq
from ..igev.blocks import BasicConvBN, BasicConvIN, Conv2x, Feature, FeatureAtt, MultiBasicEncoder
from ..igev.geometry import MultiLookup, all_pairs_correlation, avg_pool_last, lookup_dtype
from ..igev.igev import FEATURE_CHANNELS, IGEVFamily, pixel_columns, sequence_loss, stem
from ..losses import masked_smooth_l1
from ..igev.update import BasicMotionEncoder, BasicMultiUpdateBlock


class PPHourglass(nn.Module):
    """IGEV++'s 3D hourglass (`igevpp.py:53-99`): InstanceNorm throughout, a
    conv0 + feature attention stage at the volume's own scale, a c·8
    bottleneck, and a final k4 s2 deconv with no norm and no activation.
    `in_ch` in and out. Keys: conv0, conv1..3.{0,1}, conv3_up, conv2_up,
    conv1_up, agg_0.{0,1,2}, agg_1.{0,1,2}, feature_att_4, _8, _16, _32,
    _up_16, _up_8 (each feat_att.{0,1}, the first InstanceNorm)."""

    def __init__(self, in_ch: int, feat_channels: Sequence[int] = FEATURE_CHANNELS):
        super().__init__()
        c = in_ch
        f4, f8, f16, f32 = feat_channels

        def b3(cin, cout, k, s, **kw):
            return BasicConvIN(cin, cout, k, s, ndim=3, **kw)

        def att(cv, f):
            return FeatureAtt(cv, f, key="feat_att", norm="instance")

        self.conv0 = b3(c, c, 3, 1)
        self.conv1 = nn.Sequential(b3(c, 2 * c, 3, 2), b3(2 * c, 2 * c, 3, 1))
        self.conv2 = nn.Sequential(b3(2 * c, 4 * c, 3, 2), b3(4 * c, 4 * c, 3, 1))
        self.conv3 = nn.Sequential(b3(4 * c, 8 * c, 3, 2), b3(8 * c, 8 * c, 3, 1))
        self.conv3_up = b3(8 * c, 4 * c, 4, 2, deconv=True)
        self.conv2_up = b3(4 * c, 2 * c, 4, 2, deconv=True)
        self.conv1_up = BasicConvBN(2 * c, c, 4, 2, deconv=True, bn=False, relu=False, ndim=3)
        self.agg_0 = nn.Sequential(b3(8 * c, 4 * c, 1, 1), b3(4 * c, 4 * c, 3, 1),
                                   b3(4 * c, 4 * c, 3, 1))
        self.agg_1 = nn.Sequential(b3(4 * c, 2 * c, 1, 1), b3(2 * c, 2 * c, 3, 1),
                                   b3(2 * c, 2 * c, 3, 1))
        self.feature_att_4 = att(c, f4)
        self.feature_att_8 = att(2 * c, f8)
        self.feature_att_16 = att(4 * c, f16)
        self.feature_att_32 = att(8 * c, f32)
        self.feature_att_up_16 = att(4 * c, f16)
        self.feature_att_up_8 = att(2 * c, f8)

    def forward(self, x, features):
        conv0 = self.feature_att_4(self.conv0(x), features[0])
        conv1 = self.feature_att_8(self.conv1(conv0), features[1])
        conv2 = self.feature_att_16(self.conv2(conv1), features[2])
        conv3 = self.feature_att_32(self.conv3(conv2), features[3])
        conv2 = self.agg_0(torch.cat([self.conv3_up(conv3), conv2], dim=1))
        conv2 = self.feature_att_up_16(conv2, features[2])
        conv1 = self.agg_1(torch.cat([self.conv2_up(conv2), conv1], dim=1))
        conv1 = self.feature_att_up_8(conv1, features[1])
        return self.conv1_up(conv1)


class GeoEncoder(nn.Module):
    """A 1×1 conv to 128 + relu, then a 3×3 conv to 96, no relu
    (`igevpp.py:102-111`). Keys: convg1, convg2."""

    def __init__(self, cin: int):
        super().__init__()
        self.convg1 = nn.Conv2d(cin, 128, 1)
        self.convg2 = nn.Conv2d(128, 96, 3, padding=1)

    def forward(self, geo):
        return run_conv(F.relu(run_conv(geo, self.convg1)), self.convg2)


def selective_blend(sel_w: torch.Tensor, g0: torch.Tensor, g1: torch.Tensor,
                    g2: torch.Tensor) -> torch.Tensor:
    """sel_w[0]·g0 + sel_w[1]·g1 + sel_w[2]·g2, left to right, each product and
    sum in the inputs' dtype as jnp's (`igevpp.py:157-158`): in bf16 the
    order moves the roundings."""
    return sel_w[:, 0:1] * g0 + sel_w[:, 1:2] * g1 + sel_w[:, 2:3] * g2


class PPUpdateBlock(BasicMultiUpdateBlock):
    """IGEV's three-scale cascade with IGEV++'s multi-range fusion
    (`igevpp.py:132-171`): at 1/4, each range's taps through its own
    `GeoEncoder`, blended sel_w[0]·g0 + sel_w[1]·g1 + sel_w[2]·g2 in that
    order, then concatenated with the correlation taps for the motion
    encoder (`BasicDispEncoder`, `:114-129`: 128 features); mask_feat_4 has
    64 channels. Keys: geo_encoder0..2, encoder,
    gru04, gru08, gru16, disp_head, mask_feat_4.0."""

    def __init__(self, hidden_dims: Sequence[int] = (128, 128, 128), n_gru_layers: int = 3,
                 geo_planes: Sequence[int] = (144, 72, 72), corr_planes: int = 18):
        super().__init__(hidden_dims, n_gru_layers,
                         encoder=BasicMotionEncoder(96 + corr_planes, corr=(128, 96),
                                                    disp=(32, 32)),
                         mask_ch=64)
        for i, cin in enumerate(geo_planes):
            setattr(self, f"geo_encoder{i}", GeoEncoder(cin))

    def forward(self, net, inp, geo0=None, geo1=None, geo2=None, init_corr=None, sel_w=None,
                disp=None, iter04: bool = True, iter08: bool = True, iter16: bool = True,
                update: bool = True):
        geo = None
        if iter04:
            g0, g1, g2 = (getattr(self, f"geo_encoder{i}")(g) for i, g in
                          enumerate((geo0, geo1, geo2)))
            geo = selective_blend(sel_w, g0, g1, g2)
            geo = torch.cat([geo, init_corr.to(geo.dtype)], dim=1)
        return super().forward(net, inp, geo, disp, iter04=iter04, iter08=iter08,
                               iter16=iter16, update=update)


class IGEVPP(IGEVFamily):
    """forward(data) → {'disp_pred': [B,H,W]}, in training also 'init_disp'
    (the three ranges' [B,H,W]) and 'disp_preds' (TRAIN_ITERS of them).

    data['left'] / data['right']: [B,3,H,W], H and W multiples of 32. Dtypes
    as IGEV's. Keys follow the reference IGEVPPStereo state_dict.
    """

    GROUPS = 8

    def __init__(self, max_disp: int = 768, s_disp_range: int = 48, s_disp_interval: int = 1,
                 m_disp_range: int = 96, m_disp_interval: int = 2, l_disp_range: int = 192,
                 l_disp_interval: int = 4, hidden_dims: Sequence[int] = (128, 128, 128),
                 n_gru_layers: int = 3, n_downsample: int = 2, corr_levels: int = 2,
                 corr_radius: int = 4, train_iters: int = 22, valid_iters: int = 32,
                 disp_caps: Sequence[float] = (192.0, 384.0, 700.0),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if n_downsample != 2:
            raise NotImplementedError(f"IGEVPP n_downsample {n_downsample}: the port takes 2, "
                                      "as every config sets (the upsampling is ×4)")
        self.max_disp, self.dtype = max_disp, dtype
        self.ranges = ((s_disp_range, s_disp_interval), (m_disp_range, m_disp_interval),
                       (l_disp_range, l_disp_interval))
        self.hidden_dims, self.n_gru_layers = tuple(hidden_dims), n_gru_layers
        self.corr_levels, self.corr_radius = corr_levels, corr_radius
        self.train_iters, self.valid_iters = train_iters, valid_iters
        self.disp_caps = tuple(float(c) for c in disp_caps)
        hd = list(hidden_dims)
        c4 = FEATURE_CHANNELS[0]
        g = self.GROUPS

        self.feature = Feature()
        self.stem_2 = stem(3, 32, 2)
        self.stem_4 = stem(32, 48, 2)
        self.spx_4 = stem(c4, 64, 1)
        self.spx_2 = Conv2x(64, 32, norm="instance")
        self.spx = nn.Sequential(nn.ConvTranspose2d(64, 9, 4, 2, 1))
        self.spx_2_gru = Conv2x(64, 32, norm="instance")
        self.spx_gru = nn.Sequential(nn.ConvTranspose2d(64, 9, 4, 2, 1))
        self.conv = BasicConvIN(c4, c4, 3, 1)
        self.desc = nn.Conv2d(c4, c4, 1)
        self.patch0 = nn.Conv3d(g, g, (2, 1, 1), (2, 1, 1), bias=False)
        self.patch1 = nn.Conv3d(g, g, (4, 1, 1), (4, 1, 1), bias=False)
        for i in range(3):
            setattr(self, f"cost_agg{i}", PPHourglass(g))
        self.classifier = nn.Conv3d(g, 1, 3, 1, 1, bias=False)
        self.disp_conv = nn.Sequential(BasicConvIN(3, 64, 1, 1), BasicConvIN(64, 64, 3, 1))
        self.selective_conv = nn.Sequential(BasicConvIN(c4 + 64, 128, 1, 1),
                                            BasicConvIN(128, 128, 3, 1),
                                            nn.Conv2d(128, 3, 3, padding=1, bias=False))
        self.cnet = MultiBasicEncoder([hd, hd])
        self.context_zqr_convs = nn.ModuleList(nn.Conv2d(hd[i], hd[i] * 3, 3, padding=1)
                                               for i in range(3))
        taps = 2 * corr_radius + 1
        self.update_block = PPUpdateBlock(hd[::-1], n_gru_layers,
                                          (corr_levels * taps * g, taps * g, taps * g),
                                          corr_levels * taps)

    def gru_iteration(self, net, inp, geo_lookup, corr_lookup, sel_w, coords, disp):
        """One iteration (`igevpp.py:174-215`): disp [B,1,H,W] f32 → (net, the
        new disp, mask_feat_4)."""
        r, n = self.corr_radius, self.corr_levels
        dx = torch.arange(-r, r + 1, dtype=disp.dtype, device=disp.device)
        d0 = disp[:, 0]
        parts = geo_lookup([d0[..., None] / (2.0 ** i) + dx for i in range(n)]
                           + [d0[..., None] / 2.0 + dx, d0[..., None] / 4.0 + dx])
        nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731
        geo0 = nchw(torch.cat(parts[:n], dim=-1))
        init_corr = nchw(torch.cat(corr_lookup(
            [(coords - d0)[..., None] / (2.0 ** i) + dx for i in range(n)]), dim=-1))
        net, mask_feat_4, delta = self.update_block(
            net, inp, geo0, nchw(parts[n]), nchw(parts[n + 1]), init_corr, sel_w, disp,
            iter16=self.n_gru_layers == 3, iter08=self.n_gru_layers >= 2)
        return net, disp + delta, mask_feat_4

    def forward(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        image1, image2 = data["left"].to(self.dtype), data["right"].to(self.dtype)
        feats_l, stem_2x, match_left, match_right = self.descriptors(image1, image2)
        (s, _), (m, _), _ = self.ranges
        volume = self.gwc(match_left, match_right, self.max_disp // 4, self.GROUPS)
        volumes = (volume[:, :, :s], run_conv(volume[:, :, :m], self.patch0),
                   run_conv(volume, self.patch1))
        geos = [getattr(self, f"cost_agg{i}")(v, feats_l) for i, v in enumerate(volumes)]
        agg = [self.regress(geo, rng, interval)
               for geo, (rng, interval) in zip(geos, self.ranges)]

        df = run_seq(torch.stack(agg, dim=1).to(self.dtype), self.disp_conv)
        sw = run_seq(torch.cat([feats_l[0], df], dim=1), self.selective_conv)
        sel_w = torch.sigmoid(sw)

        net, inp = self.context(image1)
        ld = lookup_dtype(self.dtype)
        to_lookup = lambda v: v.to(ld).permute(0, 3, 4, 1, 2).contiguous()  # noqa: E731
        geo0_pyramid = [to_lookup(geos[0])]
        for _ in range(self.corr_levels - 1):
            geo0_pyramid.append(avg_pool_last(geo0_pyramid[-1]))
        geo_lookup = MultiLookup(geo0_pyramid + [to_lookup(geos[1]), to_lookup(geos[2])])
        corr_pyramid = [all_pairs_correlation(match_left.to(ld), match_right.to(ld))[:, :, :, None]]
        for _ in range(self.corr_levels - 1):
            corr_pyramid.append(avg_pool_last(corr_pyramid[-1]))
        iterates = self.refine(net, inp, geo_lookup, MultiLookup(corr_pyramid), sel_w,
                               pixel_columns(agg[0]), disp=agg[0])
        return self.outputs(iterates, stem_2x, feats_l[0], agg)

    def get_loss(self, pred: Dict, data: Dict):
        """The three range heads' smooth-L1 weighted 1.0, 0.5 and 0.2, each over
        0 < gt < max_disp below its cap, plus the γ-weighted L1 over the
        iterates below the last cap (`igevpp.py:416-432`)."""
        gt = data["disp"]
        valid = (gt < self.max_disp) & (gt > 0)
        loss = 0.0
        for w, p, cap in zip((1.0, 0.5, 0.2), pred["init_disp"], self.disp_caps):
            loss = loss + w * masked_smooth_l1(p, gt, valid & (gt < cap))
        loss = sequence_loss(loss, pred["disp_preds"], gt, valid & (gt < self.disp_caps[-1]))
        return loss, {"loss_disp": loss}
