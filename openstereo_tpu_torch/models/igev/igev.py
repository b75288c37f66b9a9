"""IGEV-Stereo, NCHW / NCDHW (counterpart of `openstereo_tpu/models/igev/igev.py:46-348`).

- Both views through the MobileNetV2 + decoder `Feature` and the stems:
  in eval as one 2B batch, in training one view after the other (left,
  then right), so that each BatchNorm takes each view's own statistics, as
  the JAX model's training does (`igev.py:196-223`); at 1/4 the decoder's
  48 channels and the stem's 48 make 96, from which `conv` and `desc` make
  the matching descriptors;
- the group-wise volume (8 groups, D/4 planes) through the CUDA kernel K3
  in eval (`ops.gwc_volume`; on a CPU tensor, its plain version), through
  the plain builder in training (K3 has no backward), a 3D stem gated by
  the image features, and `GeoHourglass`: the geometry encoding volume;
- the initial disparity by soft-argmax over its classified planes;
- the context net's hidden states (tanh) and per-GRU biases;
- VALID_ITERS (eval) or TRAIN_ITERS (training) slow-fast GRU iterations in
  a plain loop, each reading the geometry and all-pairs-correlation
  pyramids, built once, by gather (`geometry.CombinedGeoEncodingVolume`),
  the carried disparity detached at the top of each (`carried`), each
  iteration under `remat` with MODEL.REMAT in training;
- in eval the last iterate upsampled ×4 by the superpixel weights of
  `spx_2_gru` and `spx_gru`; in training every iterate, the iterations
  folded into the batch (one set of BatchNorm statistics over all of
  them), and the initial disparity through the training heads `spx_4`,
  `spx_2` and `spx`;
- the loss: smooth-L1 on the upsampled initial disparity plus the
  γ-weighted L1 over the iterates (`sequence_loss`).

The trunk's stride-1 inverted residuals run the fused MBConv kernel K2 in
eval. Images come in [0,255] and are rescaled to [-1,1] inside, as the JAX
model does (`igev.py:192-193`), also after a NormalizeImage transform.
`IGEVFamily` holds what IGEV-RT, StereoBase and IGEV++ share with it.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import build_gwc_volume, context_upsample, disparity_regression, gwc_volume
from ..layers import ConvBlock, head_dtype, remat, run_conv, run_seq, siamese
from ..losses import disp_valid_mask, masked_l1, masked_smooth_l1
from .blocks import BasicConvBN, BasicConvIN, Conv2x, Feature, FeatureAtt, MultiBasicEncoder
from .geometry import CombinedGeoEncodingVolume, lookup_dtype
from .update import BasicMultiUpdateBlock

FEATURE_CHANNELS = (96, 64, 192, 160)  # features at 1/4 (with the stem's 48), 1/8, 1/16, 1/32


def carried(disp: torch.Tensor) -> torch.Tensor:
    """The disparity carried into a GRU iteration, detached (the JAX loop's
    `jax.lax.stop_gradient`, `igev.py:119`): the gradient reaches the update
    block only through each iteration's own delta."""
    return disp.detach()


def sequence_loss(loss: torch.Tensor, preds, gt: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """`loss` plus Σ γ^(n-1-i) · masked L1 of iterate i over the n iterates
    `preds`, γ = 0.9^(15/(n-1)), added in order (`igev.py:343-348`)."""
    n = len(preds)
    gamma = 0.9 ** (15.0 / max(n - 1, 1))
    for i, p in enumerate(preds):
        loss = loss + (gamma ** (n - i - 1)) * masked_l1(p, gt, mask)
    return loss


def init_sequence_loss(pred: Dict, data: Dict, max_disp: float):
    """Smooth-L1 on the upsampled initial disparity plus the γ-weighted L1
    over the iterates, both over 0 < gt < max_disp (`igev.py:339-348`; also
    FoundationStereo's, FastFoundationStereo's and MonSter's) → (loss,
    {'loss_disp': loss})."""
    gt = data["disp"]
    mask = disp_valid_mask(gt, max_disp)
    loss = sequence_loss(masked_smooth_l1(pred["init_disp"], gt, mask), pred["disp_preds"], gt,
                         mask)
    return loss, {"loss_disp": loss}


def upsample_folded(upsample, iterates, stem_2x: torch.Tensor):
    """Every iterate (disp [B,1,h,w], mask features) ×4 through `upsample` in
    one call, the iterations folded into the batch, iteration-major
    (`igev.py:309-319`: `spx_2_gru`'s BatchNorm takes one set of statistics
    over all of them and updates its running ones once) → a list of
    [B,H,W]."""
    n = len(iterates)
    up = upsample(torch.cat([d for d, _ in iterates]), torch.cat([m for _, m in iterates]),
                  stem_2x.repeat(n, 1, 1, 1))
    return list(up.chunk(n))


def unit_range(image: torch.Tensor) -> torch.Tensor:
    """[0,255] → [-1,1] in at least f32 (`igev.py:192-193`; an f64 image
    stays f64)."""
    return 2.0 * (image.to(head_dtype(image.dtype)) / 255.0) - 1.0


def pixel_columns(like: torch.Tensor) -> torch.Tensor:
    """The column index of each pixel of a [B,H,W] map, f32."""
    b, h, w = like.shape
    return torch.arange(w, dtype=torch.float32, device=like.device).expand(b, h, w)


def stem(cin: int, cout: int, stride: int, spelling: str = "igev") -> nn.Sequential:
    """BasicConvIN, then a plain conv + InstanceNorm + ReLU (`igev.py:203-210`).
    Keys: 0.conv, 1 (IGEV's reference), or with `spelling` "block" 0.block.0,
    1.block.0 (StereoBase's two BasicConv2d)."""
    if spelling == "block":
        return nn.Sequential(BasicConvIN(cin, cout, 3, stride, spelling="block"),
                             ConvBlock(cout, cout, 3, 1, norm="instance", act=F.relu))
    return nn.Sequential(BasicConvIN(cin, cout, 3, stride),
                         nn.Conv2d(cout, cout, 3, 1, 1, bias=False),
                         nn.InstanceNorm2d(cout), nn.ReLU())


class GeoHourglass(nn.Module):
    """The three-level 3D hourglass with feature attention at every scale
    (`igev.py:46-93`); `in_ch` in and out; its blocks in `spelling` (IGEV's
    `.conv`/`.bn`, or StereoBase's `.block.0`/`.block.1`). Keys: conv1..3.{0,1},
    conv3_up, conv2_up, conv1_up (no norm, no activation), agg_0.{0,1,2},
    agg_1.{0,1,2}, feature_att_8, _16, _32, _up_16, _up_8."""

    def __init__(self, in_ch: int, feat_channels: Sequence[int] = FEATURE_CHANNELS,
                 spelling: str = "igev"):
        super().__init__()
        c, f8, f16, f32 = in_ch, feat_channels[1], feat_channels[2], feat_channels[3]

        def b3(cin, cout, k, s, **kw):
            return BasicConvBN(cin, cout, k, s, ndim=3, spelling=spelling, **kw)

        def att(cv, f):
            return FeatureAtt(cv, f, key="feat_att", spelling=spelling)

        self.conv1 = nn.Sequential(b3(c, 2 * c, 3, 2), b3(2 * c, 2 * c, 3, 1))
        self.conv2 = nn.Sequential(b3(2 * c, 4 * c, 3, 2), b3(4 * c, 4 * c, 3, 1))
        self.conv3 = nn.Sequential(b3(4 * c, 6 * c, 3, 2), b3(6 * c, 6 * c, 3, 1))
        self.conv3_up = b3(6 * c, 4 * c, 4, 2, deconv=True)
        self.conv2_up = b3(4 * c, 2 * c, 4, 2, deconv=True)
        self.conv1_up = b3(2 * c, c, 4, 2, deconv=True, bn=False, relu=False)
        self.agg_0 = nn.Sequential(b3(8 * c, 4 * c, 1, 1), b3(4 * c, 4 * c, 3, 1),
                                   b3(4 * c, 4 * c, 3, 1))
        self.agg_1 = nn.Sequential(b3(4 * c, 2 * c, 1, 1), b3(2 * c, 2 * c, 3, 1),
                                   b3(2 * c, 2 * c, 3, 1))
        self.feature_att_8 = att(2 * c, f8)
        self.feature_att_16 = att(4 * c, f16)
        self.feature_att_32 = att(6 * c, f32)
        self.feature_att_up_16 = att(4 * c, f16)
        self.feature_att_up_8 = att(2 * c, f8)

    def forward(self, x, features):
        conv1 = self.feature_att_8(self.conv1(x), features[1])
        conv2 = self.feature_att_16(self.conv2(conv1), features[2])
        conv3 = self.feature_att_32(self.conv3(conv2), features[3])
        conv2 = self.agg_0(torch.cat([self.conv3_up(conv3), conv2], dim=1))
        conv2 = self.feature_att_up_16(conv2, features[2])
        conv1 = self.agg_1(torch.cat([self.conv2_up(conv2), conv1], dim=1))
        conv1 = self.feature_att_up_8(conv1, features[1])
        return self.conv1_up(conv1)


class IGEVFamily(nn.Module):
    """What IGEV, IGEV-RT, StereoBase, IGEV++ and MonSter share, over the attributes
    each holds under the reference's names: `feature`, `stem_2`, `stem_4`,
    `conv`, `desc` (the matching descriptors), `classifier`, `cnet` and
    `context_zqr_convs` (the context net), `update_block`, `spx_2_gru` and
    `spx_gru` (the iterates' superpixel upsample), `spx_4`, `spx_2` and
    `spx` (the training heads); and `valid_iters` (StereoBase: `eval_iters`),
    `train_iters` and, IGEV's only, as in the JAX package, `remat`
    (MODEL.REMAT: each GRU iteration recomputed in the backward). MonSter
    holds no `feature` or `cnet`: its features and context come from its
    mono branch. `use_kernels` routes the group-wise volume through K3 in eval
    (`set_kernels`); the trunk's blocks hold their own switch for K2."""

    use_kernels = True
    remat = False

    @property
    def iters(self) -> int:
        """The GRU iterations of this mode: TRAIN_ITERS in training, else the
        eval count."""
        return self.train_iters if self.training else self.valid_iters

    def _stems(self, x):
        s2 = run_seq(x, self.stem_2)
        return s2, run_seq(s2, self.stem_4)

    def descriptors(self, image1: torch.Tensor, image2: torch.Tensor):
        """Both views through `Feature` and the stems, as one 2B batch in eval
        and one view after the other in training (each BatchNorm updated
        left, then right) → (the left features, 1/4 with the stem's 48
        channels, then 1/8, 1/16, 1/32; the left 1/2 stem; the left and right
        matching descriptors)."""
        if self.training:
            feats_l, feats_r = self.feature(image1), self.feature(image2)
            (stem_2x, stem_4x), (_, stem_4y) = self._stems(image1), self._stems(image2)
        else:
            feats_l, feats_r = siamese(self.feature, image1, image2)
            (stem_2x, stem_4x), (_, stem_4y) = siamese(self._stems, image1, image2)
        feats_l[0] = torch.cat([feats_l[0], stem_4x], dim=1)
        feats_r[0] = torch.cat([feats_r[0], stem_4y], dim=1)
        match_left = run_conv(self.conv(feats_l[0]), self.desc).contiguous()
        match_right = run_conv(self.conv(feats_r[0]), self.desc).contiguous()
        return feats_l, stem_2x, match_left, match_right

    def gwc(self, match_left: torch.Tensor, match_right: torch.Tensor, max_disp: int,
            groups: int) -> torch.Tensor:
        """The group-wise volume [B,G,D,H,W]: K3 in eval, its plain version
        with kernels off and in training (K3's wrapper has no backward)."""
        volume = gwc_volume if self.use_kernels and not self.training else build_gwc_volume
        return volume(match_left, match_right, max_disp, groups)

    def regress(self, geo_volume: torch.Tensor, max_disp: int, interval: int = 1):
        """Soft-argmax over the classified planes, in at least f32 → [B,H,W]."""
        cost = run_conv(geo_volume, self.classifier)[:, 0]
        prob = torch.softmax(cost.to(head_dtype(self.dtype)), dim=1)
        return disparity_regression(prob, max_disp, dim=1, interval=interval)

    def context(self, image1: torch.Tensor):
        """The context net → (hidden states tanh, per-GRU (cz, cr, cq) biases)."""
        cnet = self.cnet(image1)
        net = [torch.tanh(o[0]) for o in cnet]
        inp = [tuple(torch.chunk(run_conv(F.relu(o[1]), conv), 3, dim=1))
               for o, conv in zip(cnet, self.context_zqr_convs)]
        return net, inp

    def gru_iteration(self, net, inp, geo_fn, coords, disp):
        """One IGEV iteration, slow-fast where `slow_fast_gru` (`igev.py:96-158`):
        disp [B,1,H,W] f32 → (net, the new disp, mask_feat_4)."""
        geo = geo_fn(disp[:, 0], coords).permute(0, 3, 1, 2)
        ub = self.update_block
        n = self.n_gru_layers
        if n == 3 and self.slow_fast_gru:
            net = ub(net, inp, iter16=True, iter08=False, iter04=False, update=False)
        if n >= 2 and self.slow_fast_gru:
            net = ub(net, inp, iter16=n == 3, iter08=True, iter04=False, update=False)
        net, mask_feat_4, delta = ub(net, inp, geo, disp, iter16=n == 3, iter08=n >= 2)
        return net, disp + delta, mask_feat_4

    def refine(self, net, *consts, disp: torch.Tensor):
        """`iters` of `gru_iteration` from disp [B,H,W], the disparity
        `carried` into each; in training each under `remat` with MODEL.REMAT
        (`igev.py:178-182`: flax's `nn.remat` of the scanned cell) → the
        iterates (disp [B,1,H,W], mask_feat_4): every one in training, the
        last in eval."""
        disp, out = disp[:, None], []
        for _ in range(self.iters):
            args = (net, *consts, carried(disp))
            if self.remat and self.training:
                net, disp, mask_feat_4 = remat(self.gru_iteration, *args)
            else:
                net, disp, mask_feat_4 = self.gru_iteration(*args)
            out = out + [(disp, mask_feat_4)] if self.training else [(disp, mask_feat_4)]
        return out

    def upsample(self, disp: torch.Tensor, mask_feat_4: torch.Tensor,
                 stem_2x: torch.Tensor) -> torch.Tensor:
        """The 1/4 disparity [B,1,H,W] ×4 by the superpixel weights → [B,H,W]."""
        x = self.spx_2_gru(mask_feat_4, stem_2x)
        spx = torch.softmax(run_seq(x, self.spx_gru).to(head_dtype(self.dtype)), dim=1)
        return context_upsample(disp[:, 0] * 4.0, spx)

    def init_upsample(self, feat4: torch.Tensor, stem_2x: torch.Tensor, disps):
        """The training heads (`igev.py:324-336`): superpixel weights from the
        left 1/4 features through `spx_4`, `spx_2` (with the 1/2 stem) and
        `spx`, softmax in `head_dtype`; each of `disps` [B,H/4,W/4] ×4 with
        them → [B,H,W] each."""
        x = self.spx_2(run_seq(feat4, self.spx_4), stem_2x)
        spx = torch.softmax(run_seq(x, self.spx).to(head_dtype(self.dtype)), dim=1)
        return [context_upsample(d * 4.0, spx) for d in disps]

    def outputs(self, iterates, stem_2x: torch.Tensor, feat4: torch.Tensor, init_disps):
        """{'disp_pred'}: the last iterate ×4; in training also 'disp_preds',
        every iterate ×4 (`upsample_folded`), and 'init_disp', `init_disps`
        through the training heads (one tensor, or IGEV++'s list of three)."""
        if not self.training:
            return {"disp_pred": self.upsample(*iterates[-1], stem_2x)}
        preds = upsample_folded(self.upsample, iterates, stem_2x)
        init = self.init_upsample(feat4, stem_2x, init_disps)
        return {"disp_pred": preds[-1], "init_disp": init if len(init) > 1 else init[0],
                "disp_preds": preds}


class IGEV(IGEVFamily):
    """forward(data) → {'disp_pred': [B,H,W]}, in training also 'init_disp'
    [B,H,W] and 'disp_preds' (TRAIN_ITERS of [B,H,W]).

    data['left'] / data['right']: [B,3,H,W] images in [0,255], H and W
    multiples of 32; data['disp'] [B,H,W] for the loss. `dtype` is the
    compute dtype (bf16 on the main path); parameters stay f32, the softmax
    and regression heads run in at least f32, the carried disparity stays
    f32, and the lookup pyramids are stored in `lookup_dtype`. `scan_unroll`
    (MODEL.SCAN_UNROLL, the JAX loop's `lax.scan` unroll factor) is
    numerically the identity and is ignored: the loop here is a Python
    loop. Keys follow the reference IGEVStereo state_dict.
    """

    GROUPS = 8  # the group-wise volume's groups (`igev.py:231-232`)

    def __init__(self, max_disp: int = 192, hidden_dims: Sequence[int] = (128, 128, 128),
                 n_gru_layers: int = 3, n_downsample: int = 2, slow_fast_gru: bool = True,
                 corr_levels: int = 2, corr_radius: int = 4, train_iters: int = 22,
                 valid_iters: int = 32, remat: bool = False, scan_unroll: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if n_downsample != 2:
            raise NotImplementedError(f"IGEV n_downsample {n_downsample}: the port takes 2, as "
                                      "every config sets (the upsampling is ×4)")
        self.max_disp, self.dtype = max_disp, dtype
        self.hidden_dims = tuple(hidden_dims)
        self.n_gru_layers, self.slow_fast_gru = n_gru_layers, slow_fast_gru
        self.corr_levels, self.corr_radius = corr_levels, corr_radius
        self.train_iters, self.valid_iters, self.remat = train_iters, valid_iters, remat
        self.scan_unroll = scan_unroll
        hd = list(hidden_dims)
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
        self.corr_stem = BasicConvBN(self.GROUPS, self.GROUPS, 3, 1, ndim=3)
        self.corr_feature_att = FeatureAtt(self.GROUPS, c4, key="feat_att")
        self.cost_agg = GeoHourglass(self.GROUPS)
        self.classifier = nn.Conv3d(self.GROUPS, 1, 3, 1, 1, bias=False)
        self.cnet = MultiBasicEncoder([hd, hd])
        self.context_zqr_convs = nn.ModuleList(nn.Conv2d(hd[i], hd[i] * 3, 3, padding=1)
                                               for i in range(3))
        cor_planes = corr_levels * (2 * corr_radius + 1) * (self.GROUPS + 1)
        self.update_block = BasicMultiUpdateBlock(hd[::-1], n_gru_layers, cor_planes)

    def forward(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        image1, image2 = (unit_range(data[k]).to(self.dtype) for k in ("left", "right"))
        feats_l, stem_2x, match_left, match_right = self.descriptors(image1, image2)
        d4 = self.max_disp // 4
        gwc = self.gwc(match_left, match_right, d4, self.GROUPS)  # [B,8,D/4,H/4,W/4]
        gwc = self.corr_feature_att(self.corr_stem(gwc), feats_l[0])
        geo_volume = self.cost_agg(gwc, feats_l)
        init_disp = self.regress(geo_volume, d4)  # [B,H/4,W/4]
        net, inp = self.context(image1)
        ld = lookup_dtype(self.dtype)
        geo_fn = CombinedGeoEncodingVolume(match_left.to(ld), match_right.to(ld),
                                           geo_volume.to(ld), self.corr_levels, self.corr_radius)
        iterates = self.refine(net, inp, geo_fn, pixel_columns(init_disp), disp=init_disp)
        return self.outputs(iterates, stem_2x, feats_l[0], [init_disp])

    def get_loss(self, pred: Dict, data: Dict):
        """`init_sequence_loss` over 0 < gt < max_disp (`igev.py:339-348`)."""
        return init_sequence_loss(pred, data, self.max_disp)
