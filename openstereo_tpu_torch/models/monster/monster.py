"""MonSter, NCHW / NCDHW (counterpart of
`openstereo_tpu/models/monster/monster.py:59-382`).

- the mono branches (`mono_branches`): both views resized ×14/16 (align
  corners: 544×960 → 476×840, a 34×60 patch grid) through one pass of the
  frozen DINOv2 ViT as a 2B batch, whose taps feed the frozen DPT depth
  head (left view only; its relative depth resized back to H×W) and the
  trainable DPT pyramid decoder (both views); the ViT and the depth head
  run under `torch.no_grad()` (the JAX model's `stop_gradient` on the taps
  and the depth): their parameters get no gradient;
- the stereo features: `FeatTransfer` on the decoder's paths, the four
  InstanceNorm stems (1/2 and 1/4 shared by both views), the 1/4 features
  with the stem's 48 channels (96) through `conv` and `desc`;
- IGEV's volume: the group-wise volume (8 groups, D/4 planes) through the
  CUDA kernel K3 in eval (`ops.gwc_volume`; on a CPU tensor, its plain
  version), through the plain builder in training (K3 has no backward),
  the 3D stem with its feature gate, the hourglass (IGEV's `GeoHourglass`),
  the classifier and the soft-argmax initial disparity;
- the context (`FeatTransferCnet`, tanh and the `context_zqr_convs`
  biases);
- n − MIX_ITERS of IGEV's GRU iterations (no slow-fast calls; n is
  VALID_ITERS in eval, TRAIN_ITERS in training), the disparity detached at
  the top of each (`carried`), over the gathered geometry and correlation
  pyramids;
- the mono depth at 1/4 aligned to the detached stereo disparity by a
  closed-form scale and shift (`compute_scale_shift`);
- MIX_ITERS mutual-refinement iterations: both disparities detached, the
  right 1/4 features warped by both (border padding, the reference's
  half-pixel shear), and the twin `MixUpdateBlock`s, the mono branch's
  hidden states starting from the states before the first iteration;
- in eval both last iterates upsampled ×4 by the superpixel weights, and
  the stereo one refined at full resolution by `REMP`; in training every
  iterate upsampled in three folded calls (the IGEV iterations, the mutual
  ones' stereo iterates, then their mono iterates: `spx_2_gru`'s BatchNorm
  updated three times, in that order), ordered A's iterates, then each
  mutual iteration's mono and stereo ones, the last stereo one refined by
  `REMP`; and the initial disparity through the training heads;
- the loss: IGEV's (`igev.init_sequence_loss`) over all of them.

Images come as the config's transforms leave them ([-1,1] after
NormalizeToMinusOneOne); the model does not rescale them. The resizes, the
warps and REMP's inputs stay in f32; the rest runs in `dtype`.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import disp_warp, resize_linear, resize_linear_align_corners
from ..backbones.dinov2 import PATCH, VIT_CONFIGS, DinoViT
from ..backbones.dpt import DAV2_CONFIGS, DPTHead, DPTPyramidDecoder
from ..igev.blocks import BasicConvBN, BasicConvIN, Conv2x, FeatureAtt
from ..igev.geometry import CombinedGeoEncodingVolume, lookup_dtype
from ..igev.igev import (FEATURE_CHANNELS, GeoHourglass, IGEVFamily, carried,
                         init_sequence_loss, pixel_columns, stem, upsample_folded)
from ..igev.update import BasicMultiUpdateBlock
from ..layers import head_dtype, run_conv, run_seq, siamese
from .blocks import FeatTransfer, FeatTransferCnet, MixUpdateBlock, REMP, compute_scale_shift


class MonSter(IGEVFamily):
    """forward(data) → {'disp_pred': [B,H,W]}, in training also 'init_disp'
    [B,H,W], 'disp_preds' (TRAIN_ITERS + MIX_ITERS of [B,H,W] where
    TRAIN_ITERS ≥ MIX_ITERS) and 'depth_mono' [B,H,W].

    data['left'] / data['right']: [B,3,H,W] images, H and W multiples of 32.
    `dtype` is the compute dtype (bf16 on the main path); parameters stay
    f32, the softmax and regression heads run in at least f32, the carried
    disparities stay f32, the lookup pyramids are stored in `lookup_dtype`.
    Keys follow the reference MonSter state_dict as `convert_monster` reads
    it, the training heads `spx_4`, `spx_2` and `spx` included; the modules
    the reference holds and never runs are not held (`REFERENCE_ONLY_KEYS`).
    """

    GROUPS = 8  # the group-wise volume's groups (`monster.py:235`)
    REFERENCE_ONLY_KEYS = ("mono_encoder.mask_token",
                           "mono_decoder.scratch.refinenet4.resConfUnit1.",
                           "feat_decoder.scratch.refinenet4.resConfUnit1.",
                           "cost_agg.conv1_up.bn.")
    slow_fast_gru = False

    def __init__(self, max_disp: int = 192, encoder: str = "vits",
                 hidden_dims: Sequence[int] = (128, 128, 128), n_gru_layers: int = 3,
                 corr_levels: int = 2, corr_radius: int = 4, train_iters: int = 22,
                 valid_iters: int = 32, mix_iters: int = 7, dtype: torch.dtype = torch.float32):
        super().__init__()
        if mix_iters < 1:
            raise ValueError(f"MonSter needs mix_iters >= 1, got {mix_iters}")
        self.max_disp, self.encoder, self.dtype = max_disp, encoder, dtype
        self.hidden_dims = tuple(hidden_dims)
        self.n_gru_layers = n_gru_layers
        self.corr_levels, self.corr_radius = corr_levels, corr_radius
        self.train_iters, self.valid_iters, self.mix_iters = train_iters, valid_iters, mix_iters
        hd = list(hidden_dims)
        feats, out_ch = DAV2_CONFIGS[encoder]
        dim = VIT_CONFIGS[encoder][0]
        c4 = FEATURE_CHANNELS[0]

        self.mono_encoder = DinoViT(encoder)
        self.mono_decoder = DPTHead(dim, feats, out_ch)
        self.feat_decoder = DPTPyramidDecoder(dim, feats, out_ch)
        self.feat_transfer = FeatTransfer(feats)
        self.feat_transfer_cnet = FeatTransferCnet(feats, hd[0])
        self.stem_2 = stem(3, 32, 2)
        self.stem_4 = stem(32, 48, 2)
        self.stem_8 = stem(48, 96, 2)
        self.stem_16 = stem(96, 192, 2)
        self.spx_4 = stem(c4, 24, 1)
        self.spx_2 = Conv2x(24, 32, norm="instance")
        self.spx = nn.Sequential(nn.ConvTranspose2d(64, 9, 4, 2, 1))
        self.spx_2_gru = Conv2x(32, 32, norm="batch")
        self.spx_gru = nn.Sequential(nn.ConvTranspose2d(64, 9, 4, 2, 1))
        self.conv = BasicConvIN(c4, c4, 3, 1)
        self.desc = nn.Conv2d(c4, c4, 1)
        self.corr_stem = BasicConvBN(self.GROUPS, self.GROUPS, 3, 1, ndim=3)
        self.corr_feature_att = FeatureAtt(self.GROUPS, c4, key="feat_att")
        self.cost_agg = GeoHourglass(self.GROUPS)
        self.classifier = nn.Conv3d(self.GROUPS, 1, 3, 1, 1, bias=False)
        self.context_zqr_convs = nn.ModuleList(nn.Conv2d(hd[i], hd[i] * 3, 3, padding=1)
                                               for i in range(3))
        cor_planes = corr_levels * (2 * corr_radius + 1) * (self.GROUPS + 1)
        self.update_block = BasicMultiUpdateBlock(hd[::-1], n_gru_layers, cor_planes)
        self.update_block_mix_stereo = MixUpdateBlock(hd[::-1], n_gru_layers, cor_planes, c4)
        self.update_block_mix_mono = MixUpdateBlock(hd[::-1], n_gru_layers, cor_planes, c4)
        self.REMP = REMP()

    def mono_branches(self, left: torch.Tensor, right: torch.Tensor):
        """(`monster.py:59-92`) → (the relative depth [B,H,W] of the left view,
        the decoder's paths [p1 @1/4 … p4 @1/32] of both views as one 2B
        batch, left first). The ViT and the depth head are frozen: they run
        under `torch.no_grad()`."""
        h, w = left.shape[2:]
        hr, wr = h * 14 // 16, w * 14 // 16
        x = resize_linear_align_corners(torch.cat([left, right]), (hr, wr)).to(self.dtype)
        ph, pw = hr // PATCH, wr // PATCH
        b = left.shape[0]
        with torch.no_grad():
            taps = self.mono_encoder(x)
            _, depth = self.mono_decoder([(t[:b], c[:b]) for t, c in taps], ph, pw, depth=True)
        depth = resize_linear(depth[:, None], (h, w))[:, 0]
        return depth, self.feat_decoder(taps, ph, pw)

    def images(self, data: Dict[str, torch.Tensor]):
        return [data[k].to(head_dtype(data[k].dtype)) for k in ("left", "right")]

    def stereo_features(self, left: torch.Tensor, right: torch.Tensor, pyr):
        """(`monster.py:207-233`) The decoder's paths of both views (2B) →
        (feats_l [96 @1/4 with the stem's 48, 64, 192, 160], feats_r, the left
        stems [1/2, 1/4, 1/8, 1/16], match_left, match_right)."""
        b = left.shape[0]
        feats_l, feats_r = (list(f) for f in zip(*(f.split(b) for f in self.feat_transfer(pyr))))
        (stem_2x, stem_4x), (_, stem_4y) = siamese(self._stems, left.to(self.dtype),
                                                   right.to(self.dtype))
        stem_8x = run_seq(stem_4x, self.stem_8)
        stem_16x = run_seq(stem_8x, self.stem_16)
        feats_l[0] = torch.cat([feats_l[0], stem_4x], dim=1)
        feats_r[0] = torch.cat([feats_r[0], stem_4y], dim=1)
        match_left = run_conv(self.conv(feats_l[0]), self.desc).contiguous()
        match_right = run_conv(self.conv(feats_r[0]), self.desc).contiguous()
        return feats_l, feats_r, [stem_2x, stem_4x, stem_8x, stem_16x], match_left, match_right

    def volume(self, feats_l, match_left: torch.Tensor, match_right: torch.Tensor):
        """(`monster.py:235-246`) → (the geometry volume [B,8,D/4,H/4,W/4], the
        initial disparity [B,H/4,W/4]): K3 in eval with kernels on."""
        d4 = self.max_disp // 4
        gwc = self.gwc(match_left, match_right, d4, self.GROUPS)
        gwc = self.corr_feature_att(self.corr_stem(gwc), feats_l[0])
        geo_volume = self.cost_agg(gwc, feats_l)
        return geo_volume, self.regress(geo_volume, d4)

    def mix_iteration(self, net, net_mono, inp, geo_fn, coords, feat_l, feat_r, disp, disp_m):
        """One mutual-refinement iteration (`monster.py:130-177`): both
        disparities [B,1,H,W] detached, each one's lookups and warp error of
        the right 1/4 features (border padding, the reference's shear), the
        twin update blocks → (net, net_mono, disp, disp_m, mask_feat_4,
        the mono branch's mask_feat_4)."""
        disp, disp_m = carried(disp), carried(disp_m)
        geo_s = geo_fn(disp[:, 0], coords).permute(0, 3, 1, 2)
        geo_m = geo_fn(disp_m[:, 0], coords).permute(0, 3, 1, 2)
        flaw_m = disp_warp(feat_r, disp_m[:, 0], "border", torch_unaligned=True)[0] - feat_l
        flaw_s = disp_warp(feat_r, disp[:, 0], "border", torch_unaligned=True)[0] - feat_l
        net, mask, delta = self.update_block_mix_stereo(net, inp, flaw_s, disp, geo_s,
                                                        flaw_m, disp_m, geo_m)
        net_mono, mask_m, delta_m = self.update_block_mix_mono(net_mono, inp, flaw_m, disp_m,
                                                               geo_m, flaw_s, disp, geo_s)
        return net, net_mono, disp + delta, disp_m + delta_m, mask, mask_m

    def forward(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        left, right = self.images(data)
        b, _, h, w = left.shape
        depth_mono, pyr = self.mono_branches(left, right)
        disp_mono_4x = resize_linear(depth_mono[:, None], (h // 4, w // 4))
        feats_l, feats_r, stems, match_left, match_right = self.stereo_features(left, right, pyr)
        geo_volume, init_disp = self.volume(feats_l, match_left, match_right)

        cnet = self.feat_transfer_cnet([p[:b] for p in pyr], stems[3:0:-1])  # 1/16, 1/8, 1/4
        net = [torch.tanh(o[0]) for o in cnet]
        inp = [tuple(torch.chunk(run_conv(F.relu(o[1]), conv), 3, dim=1))
               for o, conv in zip(cnet, self.context_zqr_convs)]
        ld = lookup_dtype(self.dtype)
        geo_fn = CombinedGeoEncodingVolume(match_left.to(ld), match_right.to(ld),
                                           geo_volume.to(ld), self.corr_levels, self.corr_radius)
        coords = pixel_columns(init_disp)

        n_a = max(self.iters - self.mix_iters, 0)
        net_mono = list(net)  # the mono branch starts from the states before the loop
        disp, phase_a = init_disp[:, None], []
        for _ in range(n_a):
            net, disp, mask = self.gru_iteration(net, inp, geo_fn, coords, carried(disp))
            phase_a += [(disp, mask)] if self.training else []
        scale, shift = compute_scale_shift(disp_mono_4x[:, 0].float(),
                                           disp[:, 0].detach().float())
        disp_m = (scale[:, None, None, None] * disp_mono_4x
                  + shift[:, None, None, None]).to(disp.dtype)
        hd = head_dtype(self.dtype)
        feat_l, feat_r = feats_l[0].to(hd), feats_r[0].to(hd)
        phase_b = []
        for _ in range(self.iters - n_a):
            net, net_mono, disp, disp_m, mask, mask_m = self.mix_iteration(
                net, net_mono, inp, geo_fn, coords, feat_l, feat_r, disp, disp_m)
            phase_b = phase_b + [(disp, mask, disp_m, mask_m)] if self.training else []

        if not self.training:
            disp_up = self.upsample(disp, mask, stems[0])
            disp_m_up = self.upsample(disp_m, mask_m, stems[0])
            refined = self.REMP(disp_m_up[:, None], disp_up[:, None], left, right,
                                 self.dtype)[:, 0]
            return {"disp_pred": disp_up + refined}
        return self.training_outputs(phase_a, phase_b, stems[0], feats_l[0], init_disp,
                                     depth_mono, left, right)

    def training_outputs(self, phase_a, phase_b, stem_2x, feat4, init_disp, depth_mono, left,
                         right):
        """(`monster.py:330-369`) The iterates ×4 in three folded calls, in the
        JAX model's order: phase A's, the mutual iterations' stereo ones,
        their mono ones (`spx_2_gru`'s BatchNorm takes three sets of
        statistics); 'disp_preds' A's iterates, then each mutual iteration's
        mono and stereo ones, the last stereo one plus `REMP`'s refinement;
        'init_disp' through the training heads; 'depth_mono'."""
        preds = upsample_folded(self.upsample, phase_a, stem_2x) if phase_a else []
        ups_b = upsample_folded(self.upsample, [(d, m) for d, m, _, _ in phase_b], stem_2x)
        ups_m = upsample_folded(self.upsample, [(d, m) for _, _, d, m in phase_b], stem_2x)
        for i, (up, up_m) in enumerate(zip(ups_b, ups_m)):
            if i == len(ups_b) - 1:
                up = up + self.REMP(up_m[:, None], up[:, None], left, right, self.dtype)[:, 0]
            preds += [up_m, up]
        init = self.init_upsample(feat4, stem_2x, [init_disp])[0]
        return {"disp_pred": preds[-1], "disp_preds": preds, "init_disp": init,
                "depth_mono": depth_mono}

    def get_loss(self, pred: Dict, data: Dict):
        """Smooth-L1 on the initial disparity plus the γ-weighted L1 over all
        the iterates, mono and stereo, γ = 0.9^(15/(n−1)), over 0 < gt <
        max_disp (`monster.py:371-382`)."""
        return init_sequence_loss(pred, data, self.max_disp)
