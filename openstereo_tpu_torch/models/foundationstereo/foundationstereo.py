"""FoundationStereo, NCHW / NCDHW (counterpart of
`openstereo_tpu/models/foundationstereo/foundationstereo.py:88-328`).

- `FSFeature`: both views through the EdgeNeXt trunk, the Conv2x_IN
  decoder to 1/4, and the frozen DepthAnythingV2 (DINOv2 ViT and DPT head)
  on the bicubic-resized views (`resize_keep_aspect`: 544×960 → 560×1008,
  40×72 patches), whose features, resized to 1/4, join the trunk's there
  (96 + features/2 channels: 224 for vitl); in eval as one 2B batch, in
  training one view after the other, as the JAX model's training runs them;
  with FREEZE_VIT (the default) the DepthAnythingV2 branch runs under
  `torch.no_grad()`: its parameters get no gradient (the JAX model's
  `stop_gradient` on its features) and keep no activations;
- the hybrid volume: the cosine group-wise volume (8 groups, D/4 planes; on
  the card in eval K3 with divisor 1 over the group-normalised features,
  `ops.gwc_volume`; the plain version `ops.build_cosine_gwc_volume` with
  kernels off, in training (K3 has no backward) or on the CPU) beside the
  concatenation volume of 12-channel projections, whose left half is not
  zeroed;
- a 3D stem with feature attention, the AHCF hourglass, the classifier and
  the soft-argmax initial disparity;
- the ViT-fused context net, one channel gate and one spatial attention
  map shared by the GRU scales;
- VALID_ITERS (eval) or TRAIN_ITERS (training) iterations of the selective
  GRU cascade in a plain loop over IGEV's gathered geometry and correlation
  pyramids, the disparity detached at the top of each (`carried`);
- in eval the last iterate upsampled ×4 by the superpixel weights of the
  norm-free `spx_2_gru` and `spx_gru`; in training every iterate, the
  iterations folded into the batch, and the initial disparity resized ×4
  (align corners);
- the loss (`get_loss`): smooth-L1 on the initial disparity plus the
  γ-weighted L1 over the iterates (`igev.init_sequence_loss`).

Images come ImageNet-normalised (the config's NormalizeImage), as the JAX
model expects them. The ViT's bicubic resize and the first convs read the
images in f32; the rest runs in `dtype`.
"""

from __future__ import annotations

import math
from contextlib import nullcontext
from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import (build_cosine_gwc_volume, build_fs_concat_volume, context_upsample,
                    disparity_regression, gwc_volume, l2_normalize, normalize_groups,
                    resize_bicubic_torch, resize_linear_align_corners)
from ..backbones.dpt import DAV2_CONFIGS, DepthAnythingV2
from ..backbones.edgenext import EdgeNeXtFeatures
from ..igev.blocks import BasicConvBN, BasicConvIN, Conv2x, FeatureAtt
from ..igev.geometry import CombinedGeoEncodingVolume, lookup_dtype
from ..igev.igev import (carried, init_sequence_loss, pixel_columns, stem,
                         upsample_folded)
from ..layers import head_dtype, run_conv, run_seq, siamese
from .blocks import (AHCFHourglass, BasicSelectiveMultiUpdateBlock, ChannelAttentionEnhancement,
                     ContextNetDino, Conv2xFS, ResnetBasicBlock3D, ResnetBasicBlockIN,
                     SpatialAttentionExtractor)


def resize_keep_aspect(h: int, w: int, divider: int = 112, max_side: int = 1344
                       ) -> Tuple[int, int]:
    """The ViT input size (`foundationstereo.py:88-100`): each side rounded up
    to a multiple of 112 (the lcm of 14 and 16), scaled down to at most
    `max_side` on the longer side."""
    def rnd(x):
        return int(math.ceil(x / divider) * divider)

    hr, wr = rnd(h), rnd(w)
    if hr > max_side or wr > max_side:
        if hr > wr:
            wr, hr = rnd(wr * max_side / hr), max_side
        else:
            hr, wr = rnd(hr * max_side / wr), max_side
    return hr, wr


def vit_feat_dim(vit_size: str) -> int:
    """The DPT feature's channels (features / 2), FoundationStereo's 1/4 budget
    beyond the trunk's 96."""
    return DAV2_CONFIGS[vit_size][0] // 2


class DepthAnythingFeature(nn.Module):
    """The reference's holder of the frozen DepthAnythingV2 (key: depth_anything)."""

    def __init__(self, vit_size: str):
        super().__init__()
        self.depth_anything = DepthAnythingV2(vit_size)


class FSFeature(EdgeNeXtFeatures):
    """EdgeNeXt trunk + Conv2x_IN decoder + the frozen DAv2 features
    (`foundationstereo.py:103-140`): [B,3,H,W] (f32, normalised) → ([y4
    (96 + vit channels) @1/4, y8 192 @1/8, y16 320 @1/16, c32 304 @1/32], the
    ViT features at 1/4), in the caller's compute `dtype`. With `freeze_vit`
    the DepthAnythingV2 branch runs under `torch.no_grad()`. Keys: the
    trunk's (stem, stages), dino, deconv32_16, deconv16_8, deconv8_4,
    conv4.{0,1,2}."""

    def __init__(self, vit_size: str = "vits", freeze_vit: bool = True):
        super().__init__()
        self.freeze_vit = freeze_vit
        vit = vit_feat_dim(vit_size)
        self.dino = DepthAnythingFeature(vit_size)
        self.deconv32_16 = Conv2xFS(304, 160)
        self.deconv16_8 = Conv2xFS(320, 96)
        self.deconv8_4 = Conv2xFS(192, 48)
        self.conv4 = nn.Sequential(BasicConvIN(96 + vit, 96 + vit, 3),
                                   ResnetBasicBlockIN(96 + vit), ResnetBasicBlockIN(96 + vit))

    def forward(self, x: torch.Tensor, dtype: torch.dtype):
        h, w = x.shape[2:]
        x_vit = resize_bicubic_torch(x, resize_keep_aspect(h, w)).to(dtype)
        with torch.no_grad() if self.freeze_vit else nullcontext():
            vit_feat, _ = self.dino.depth_anything(x_vit)
        vit_feat = resize_linear_align_corners(vit_feat, (h // 4, w // 4))
        c4, c8, c16, c32 = self.trunk(x.to(dtype))
        y16 = self.deconv32_16(c32, c16)
        y8 = self.deconv16_8(y16, c8)
        y4 = self.deconv8_4(y8, c4)
        y4 = run_seq(torch.cat([y4, vit_feat], dim=1), self.conv4)
        return [y4, y8, y16, c32], vit_feat


class FSFamily(nn.Module):
    """What FoundationStereo and FastFoundationStereo share after the features:
    the hybrid volume, its filtering and classification, the GRU loop and the
    superpixel upsample, the training outputs and the loss. Subclasses hold
    `feature`, `stem_2`, `proj_cmb`, `corr_stem`, `corr_feature_att`,
    `cost_agg`, `classifier`, `cnet`, `cam`, `sam`, `update_block`,
    `spx_2_gru`, `spx_gru`, `train_iters` and `valid_iters`. `use_kernels`
    routes the cosine volume through K3 with divisor 1 in eval
    (`set_kernels`)."""

    use_kernels = True
    GROUPS = 8  # the cosine volume's groups (`foundationstereo.py:184`, cv_groups)

    @property
    def iters(self) -> int:
        """The GRU iterations of this mode: TRAIN_ITERS in training, else
        VALID_ITERS."""
        return self.train_iters if self.training else self.valid_iters

    def _volume_modules(self, c4: int, feat_dims: Sequence[int], concat: int, headwise: bool):
        v = self.volume_dim
        self.stem_2 = stem(3, 32, 2)
        self.proj_cmb = nn.Conv2d(c4, concat // 2, 1)
        self.corr_stem = nn.Sequential(nn.Conv3d(self.GROUPS + concat, v, 1),
                                       BasicConvBN(v, v, 3, ndim=3), ResnetBasicBlock3D(v),
                                       ResnetBasicBlock3D(v))
        self.corr_feature_att = FeatureAtt(v, c4, key="feat_att")
        self.cost_agg = AHCFHourglass(v, feat_dims, headwise_att=headwise)
        self.classifier = nn.Sequential(BasicConvBN(v, v // 2, 3, ndim=3),
                                        ResnetBasicBlock3D(v // 2),
                                        nn.Conv3d(v // 2, 1, 7, padding=3))
        self.cam = ChannelAttentionEnhancement(self.hidden_dim)
        self.sam = SpatialAttentionExtractor()
        cor_planes = self.corr_levels * (2 * self.corr_radius + 1) * (v + 1)
        self.update_block = BasicSelectiveMultiUpdateBlock(
            self.hidden_dim, self.n_gru_layers, cor_planes, self.motion_fuse_kernel)
        self.spx_2_gru = Conv2x(32, 32, norm="none")
        self.spx_gru = nn.Sequential(nn.ConvTranspose2d(64, 9, 4, 2, 1))

    def features(self, left: torch.Tensor, right: torch.Tensor):
        """(left, right) through `feature`: one 2B batch in eval, one view
        after the other in training (`foundationstereo.py:209-211`)."""
        if self.training:
            return self.feature(left, self.dtype), self.feature(right, self.dtype)
        return siamese(lambda x: self.feature(x, self.dtype), left, right)

    def hybrid_volume(self, left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
        """[B, G + concat, D/4, H/4, W/4]: the cosine volume (K3 with divisor 1
        in eval with kernels on; its plain version with kernels off and in
        training, K3 having no backward) and the concatenation volume."""
        d4 = self.max_disp // 4
        if self.use_kernels and not self.training:
            gwc = gwc_volume(normalize_groups(left, self.GROUPS),
                             normalize_groups(right, self.GROUPS), d4, self.GROUPS, 1)
        else:
            gwc = build_cosine_gwc_volume(left, right, d4, self.GROUPS)
        cat = build_fs_concat_volume(run_conv(left, self.proj_cmb),
                                     run_conv(right, self.proj_cmb), d4)
        return torch.cat([gwc.to(self.dtype), cat], dim=1)

    def filtered(self, feats_l, feats_r):
        """The volume through the stem, its feature attention and the AHCF
        hourglass → (the filtered volume, the initial disparity [B,H/4,W/4])."""
        comb = run_seq(self.hybrid_volume(feats_l[0], feats_r[0]), self.corr_stem)
        comb = self.cost_agg(self.corr_feature_att(comb, feats_l[0]), feats_l)
        cost = run_seq(comb, self.classifier)[:, 0]
        prob = torch.softmax(cost.to(head_dtype(self.dtype)), dim=1)
        return comb, disparity_regression(prob, self.max_disp // 4, dim=1)

    def refine(self, cnet, feats_l, feats_r, comb, init_disp):
        """The context heads (tanh, relu; the shared channel gate and spatial
        attention), then `iters` selective GRU iterations from init_disp, the
        disparity `carried` into each → the iterates (disp [B,1,H/4,W/4], its
        mask features): every one in training, the last in eval."""
        net = [torch.tanh(o[0]) for o in cnet]
        inp = [F.relu(o[1]) for o in cnet]
        inp = [self.cam(x) * x for x in inp]
        att = [self.sam(x) for x in inp]
        ld = lookup_dtype(self.dtype)
        geo_fn = CombinedGeoEncodingVolume(l2_normalize(feats_l[0].to(ld), 1),
                                           l2_normalize(feats_r[0].to(ld), 1), comb.to(ld),
                                           self.corr_levels, self.corr_radius)
        coords = pixel_columns(init_disp)
        disp, out = init_disp[:, None], []
        for _ in range(self.iters):
            disp = carried(disp)
            geo = geo_fn(disp[:, 0], coords).permute(0, 3, 1, 2)
            net, mask_feat, delta = self.update_block(net, inp, geo, disp, att)
            disp = disp + delta
            out = out + [(disp, mask_feat)] if self.training else [(disp, mask_feat)]
        return out

    def upsample(self, disp: torch.Tensor, mask_feat: torch.Tensor,
                 stem_2x: torch.Tensor) -> torch.Tensor:
        """The 1/4 disparity [B,1,H,W] ×4 by the superpixel weights → [B,H,W]."""
        x = self.spx_2_gru(mask_feat, stem_2x)
        spx = torch.softmax(run_seq(x, self.spx_gru).to(head_dtype(self.dtype)), dim=1)
        return context_upsample(disp[:, 0] * 4.0, spx)

    def outputs(self, iterates, stem_2x: torch.Tensor, init_disp: torch.Tensor):
        """{'disp_pred'}: the last iterate ×4; in training also 'disp_preds',
        every iterate ×4 in one call with the iterations folded into the
        batch, iteration-major (`foundationstereo.py:300-314`), and
        'init_disp', the initial disparity [B,H/4,W/4] resized to H×W (align
        corners) ×4."""
        if not self.training:
            return {"disp_pred": self.upsample(*iterates[-1], stem_2x)}
        preds = upsample_folded(self.upsample, iterates, stem_2x)
        hw = tuple(4 * s for s in init_disp.shape[1:])
        init = resize_linear_align_corners(init_disp[:, None], hw)[:, 0] * 4.0
        return {"disp_pred": preds[-1], "disp_preds": preds, "init_disp": init}

    def images(self, data: Dict[str, torch.Tensor]):
        return [data[k].to(head_dtype(data[k].dtype)) for k in ("left", "right")]

    def get_loss(self, pred: Dict, data: Dict):
        """Smooth-L1 on the initial disparity plus the γ-weighted L1 over the
        iterates, γ = 0.9^(15/(n−1)), over 0 < gt < max_disp
        (`foundationstereo.py:317-328`)."""
        return init_sequence_loss(pred, data, self.max_disp)


class FoundationStereo(FSFamily):
    """forward(data) → {'disp_pred': [B,H,W]}, in training also 'init_disp'
    [B,H,W] and 'disp_preds' (TRAIN_ITERS of [B,H,W]).

    data['left'] / data['right']: [B,3,H,W] ImageNet-normalised images, H and W
    multiples of 32. `dtype` is the compute dtype (bf16 on the main path,
    the config's mixed_precision); parameters stay f32, the softmax and
    regression heads run in at least f32, the carried disparity stays f32,
    the lookup pyramids are stored in `lookup_dtype`. Keys follow the
    reference FoundationStereo state_dict as `convert_foundationstereo` reads
    it; the modules the reference holds and never runs are not held
    (`REFERENCE_ONLY_KEYS`). `freeze_vit` (MODEL.FREEZE_VIT): the
    DepthAnythingV2 branch gets no gradient; its parameters stay in the
    state_dict and the optimizer, which steps a tensor without a gradient as
    one with a zero gradient (AdamW's decay still moves it), as optax does
    to the JAX model's.
    """

    REFERENCE_ONLY_KEYS = ("stem_4.", "context_zqr_convs.", "cnet.down.", "cnet.norm.",
                           "feature.dino.depth_anything.pretrained.mask_token",
                           "feature.dino.depth_anything.depth_head.scratch.refinenet4."
                           "resConfUnit1.")

    def __init__(self, max_disp: int = 192, vit_size: str = "vits", hidden_dim: int = 128,
                 volume_dim: int = 28, n_gru_layers: int = 3, corr_levels: int = 2,
                 corr_radius: int = 4, train_iters: int = 22, valid_iters: int = 32,
                 freeze_vit: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.max_disp, self.vit_size, self.dtype = max_disp, vit_size, dtype
        self.hidden_dim, self.volume_dim, self.n_gru_layers = hidden_dim, volume_dim, n_gru_layers
        self.corr_levels, self.corr_radius = corr_levels, corr_radius
        self.train_iters, self.valid_iters = train_iters, valid_iters
        self.motion_fuse_kernel = 3
        vit = vit_feat_dim(vit_size)
        self.feature = FSFeature(vit_size, freeze_vit)
        self._volume_modules(96 + vit, (96 + vit, 192, 320, 304), 24, headwise=False)
        self.cnet = ContextNetDino((hidden_dim,) * 3, vit_feat_dim=vit)

    def forward(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        left, right = self.images(data)
        (feats_l, vit_l), (feats_r, _) = self.features(left, right)
        stem_2x = run_seq(left.to(self.dtype), self.stem_2)
        comb, init_disp = self.filtered(feats_l, feats_r)
        cnet = self.cnet(left.to(self.dtype), vit_l)
        iterates = self.refine(cnet, feats_l, feats_r, comb, init_disp)
        return self.outputs(iterates, stem_2x, init_disp)
