"""FoundationStereo building blocks, NCHW / NCDHW (counterpart of
`openstereo_tpu/models/foundationstereo/blocks.py`).

The AHCF hourglass filters the hybrid volume with reduced 3D convs ((1,k,k)
then (17,1,1)), image-feature gates and a transformer over the disparity
axis of a 4×-patchified copy of its input; the selective ConvGRU pairs a
1×1 and a 3×3 GRU gated by a spatial attention map. IGEV's `BasicConvBN`,
`BasicConvIN`, `FeatureAtt`, `ResidualBlockCtx`, `MultiBasicEncoder` and
motion encoder are reused, as the JAX package reuses its own
(`blocks.py:30`). Keys follow the reference modules as
`openstereo_tpu/utils/torch_convert.py:convert_foundationstereo` reads them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import resize_trilinear
from ..igev.blocks import BasicConvBN, BasicConvIN, FeatureAtt, MultiBasicEncoder
from ..igev.update import BasicMotionEncoder, interp_to, pool2x
from ..layers import apply_norm, gelu, head_dtype, layer_norm, linear, run_conv, run_seq


class Conv3dNormActReduced(nn.Module):
    """(1,k,k) spatial conv + (kd,1,1) disparity conv, each with its bias,
    BatchNorm and ReLU (`blocks.py:34-51`). Keys: conv1.{0,1}, conv2.{0,1}."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3, kernel_disp: int = 17):
        super().__init__()
        k, kd = kernel_size, kernel_disp
        self.conv1 = nn.Sequential(nn.Conv3d(cin, cout, (1, k, k), padding=(0, k // 2, k // 2)),
                                   nn.BatchNorm3d(cout), nn.ReLU())
        self.conv2 = nn.Sequential(nn.Conv3d(cout, cout, (kd, 1, 1), padding=(kd // 2, 0, 0)),
                                   nn.BatchNorm3d(cout), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return run_seq(run_seq(x, self.conv1), self.conv2)


class ResnetBasicBlock3D(nn.Module):
    """conv-bn-relu-conv-bn plus x, relu (`blocks.py:54-66`). Keys: conv1, bn1,
    conv2, bn2 (bias-free convs)."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Conv3d(c, c, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm3d(c)
        self.conv2 = nn.Conv3d(c, c, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm3d(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(apply_norm(run_conv(x, self.conv1), self.bn1))
        return F.relu(x + apply_norm(run_conv(y, self.conv2), self.bn2))


class ResnetFuse(nn.Module):
    """Conv2x_IN's fuse block (`blocks.py:69-88`): bias-free convs with
    non-affine InstanceNorm, relu after the first, relu(x + y). Keys: conv1,
    conv2."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 3, padding=1, bias=False)
        self.conv2 = nn.Conv2d(c, c, 3, padding=1, bias=False)
        self.norm = nn.InstanceNorm2d(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(apply_norm(run_conv(x, self.conv1), self.norm))
        return F.relu(x + apply_norm(run_conv(y, self.conv2), self.norm))


class Conv2xFS(nn.Module):
    """A k4 s2 deconv stage (InstanceNorm, leaky_relu), concatenated with the
    skip, then the residual fuse block at 2·out_ch (`blocks.py:69-88`).
    Keys: conv1.conv, conv2.conv1, conv2.conv2."""

    def __init__(self, cin: int, out_ch: int):
        super().__init__()
        self.conv1 = BasicConvIN(cin, out_ch, 4, 2, deconv=True)
        self.conv2 = ResnetFuse(2 * out_ch)

    def forward(self, x: torch.Tensor, rem: torch.Tensor) -> torch.Tensor:
        return self.conv2(torch.cat([self.conv1(x), rem], dim=1))


class ResnetBasicBlockIN(nn.Module):
    """RAFT-style block (`blocks.py:91-107`): conv (bias) + InstanceNorm + relu,
    twice, then relu(x + y). Keys: conv1, conv2."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 3, padding=1)
        self.conv2 = nn.Conv2d(c, c, 3, padding=1)
        self.norm = nn.InstanceNorm2d(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(apply_norm(run_conv(x, self.conv1), self.norm))
        y = F.relu(apply_norm(run_conv(y, self.conv2), self.norm))
        return F.relu(x + y)


class DispAttention(nn.Module):
    """Separate q, k, v and out projections (keys: q_proj, k_proj, v_proj,
    out_proj)."""

    def __init__(self, dim: int):
        super().__init__()
        self.q_proj, self.k_proj = nn.Linear(dim, dim), nn.Linear(dim, dim)
        self.v_proj, self.out_proj = nn.Linear(dim, dim), nn.Linear(dim, dim)


class DispTransformerLayer(nn.Module):
    """Post-norm transformer layer over the disparity axis of [B', D, C]
    (`blocks.py:110-150`). `headwise` is FastFoundationStereo's quirk: its
    reference feeds (B, L, H, D) tensors to `scaled_dot_product_attention`,
    which attends over the heads at each disparity instead of over the
    disparities. Keys: self_attn.*, linear1, linear2, norm1, norm2."""

    def __init__(self, dim: int, num_heads: int = 4, ffn: int = 28, headwise: bool = False):
        super().__init__()
        self.num_heads, self.headwise = num_heads, headwise
        self.self_attn = DispAttention(dim)
        self.linear1 = nn.Linear(dim, ffn)
        self.linear2 = nn.Linear(ffn, dim)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, d, c = x.shape
        nh = self.num_heads
        hd = c // nh
        a = self.self_attn
        q = linear(x, a.q_proj).reshape(b, d, nh, hd) * hd ** -0.5
        k = linear(x, a.k_proj).reshape(b, d, nh, hd)
        v = linear(x, a.v_proj).reshape(b, d, nh, hd)
        if self.headwise:
            attn = torch.einsum("bdhc,bdgc->bdhg", q, k)
            p = torch.softmax(attn.to(head_dtype(x.dtype)), dim=-1).to(v.dtype)
            y = torch.einsum("bdhg,bdgc->bdhc", p, v).reshape(b, d, c)
        else:
            attn = torch.einsum("bdhc,behc->bhde", q, k)
            p = torch.softmax(attn.to(head_dtype(x.dtype)), dim=-1).to(v.dtype)
            y = torch.einsum("bhde,behc->bdhc", p, v).reshape(b, d, c)
        x = layer_norm(x + linear(y, a.out_proj), self.norm1)
        y = linear(gelu(linear(x, self.linear1)), self.linear2)
        return layer_norm(x + y, self.norm2)


def sincos_table(max_len: int, dim: int) -> np.ndarray:
    """The sin/cos position table [max_len, dim] in f32 (`blocks.py:153-163`,
    copied)."""
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float32)
                 * np.float32(-(np.log(10000.0) / dim)))[None]
    out = np.zeros((max_len, dim), np.float32)
    out[:, 0::2] = np.sin(pos * div)
    out[:, 1::2] = np.cos(pos * div[:, : out[:, 1::2].shape[1]])
    return out


class CostVolumeDisparityAttention(nn.Module):
    """Self-attention along D at every voxel column of [B,C,D,H,W]
    (`blocks.py:166-185`): the sin/cos table added, then `num_layers` layers.
    Keys: sa.i."""

    def __init__(self, dim: int, num_heads: int = 4, ffn: int = 28, num_layers: int = 4,
                 headwise: bool = False):
        super().__init__()
        self.sa = nn.ModuleList(DispTransformerLayer(dim, num_heads, ffn, headwise)
                                for _ in range(num_layers))

    def forward(self, vol: torch.Tensor) -> torch.Tensor:
        b, c, d, h, w = vol.shape
        x = vol.permute(0, 3, 4, 2, 1).reshape(b * h * w, d, c)
        x = x + torch.from_numpy(sincos_table(d, c)).to(x.device, x.dtype)
        for layer in self.sa:
            x = layer(x)
        return x.reshape(b, h, w, d, c).permute(0, 4, 3, 1, 2)


class AHCFHourglass(nn.Module):
    """Attentive hybrid cost filtering (`blocks.py:188-267`): three stride-2
    levels of a 3D conv (BatchNorm, leaky_relu) and a reduced conv, each gated
    by the image features at its scale; a decoder with skip aggregation; and
    a disparity transformer on the 4×-patchified input volume (a depthwise
    4×4×4 stride-4 conv with BatchNorm), resized trilinearly ×4 and added
    before the two output convs. `features` = the volume's channels,
    `feat_dims` = the image features' per scale. Keys: conv1..3.{0,1},
    conv3_up, conv2_up, conv1_up, agg_0.{0,1,2}, agg_1.{0,1,2}, feature_att_8,
    _16, _32, _up_16, _up_8, conv_patch.{0,1}, atts.4, conv_out.{0,1}."""

    def __init__(self, features: int, feat_dims: Sequence[int], headwise_att: bool = False):
        super().__init__()
        c = features

        def down(cin, cout):
            return nn.Sequential(BasicConvBN(cin, cout, 3, 2, ndim=3),
                                 Conv3dNormActReduced(cout, cout))

        def agg(cin, cout):
            return nn.Sequential(BasicConvBN(cin, cout, 1, 1, ndim=3),
                                 Conv3dNormActReduced(cout, cout), Conv3dNormActReduced(cout, cout))

        def att(cv, f):
            return FeatureAtt(cv, f, key="feat_att")

        self.conv1, self.conv2, self.conv3 = down(c, 2 * c), down(2 * c, 4 * c), down(4 * c, 6 * c)
        self.conv3_up = BasicConvBN(6 * c, 4 * c, 4, 2, deconv=True, ndim=3)
        self.conv2_up = BasicConvBN(4 * c, 2 * c, 4, 2, deconv=True, ndim=3)
        self.conv1_up = BasicConvBN(2 * c, c, 4, 2, deconv=True, ndim=3)
        self.agg_0, self.agg_1 = agg(8 * c, 4 * c), agg(4 * c, 2 * c)
        self.feature_att_8 = att(2 * c, feat_dims[1])
        self.feature_att_16 = att(4 * c, feat_dims[2])
        self.feature_att_32 = att(6 * c, feat_dims[3])
        self.feature_att_up_16 = att(4 * c, feat_dims[2])
        self.feature_att_up_8 = att(2 * c, feat_dims[1])
        self.conv_patch = nn.Sequential(nn.Conv3d(c, c, 4, 4, groups=c), nn.BatchNorm3d(c))
        self.atts = nn.ModuleDict({"4": CostVolumeDisparityAttention(
            c, num_heads=4, ffn=c, num_layers=4, headwise=headwise_att)})
        self.conv_out = nn.Sequential(Conv3dNormActReduced(c, c), Conv3dNormActReduced(c, c))

    def forward(self, x: torch.Tensor, features: Sequence[torch.Tensor]) -> torch.Tensor:
        conv1 = self.feature_att_8(run_seq(x, self.conv1), features[1])
        conv2 = self.feature_att_16(run_seq(conv1, self.conv2), features[2])
        conv3 = self.feature_att_32(run_seq(conv2, self.conv3), features[3])
        y = run_seq(torch.cat([self.conv3_up(conv3), conv2], dim=1), self.agg_0)
        y = self.feature_att_up_16(y, features[2])
        y = run_seq(torch.cat([self.conv2_up(y), conv1], dim=1), self.agg_1)
        y = self.feature_att_up_8(y, features[1])
        y = self.conv1_up(y)
        patch = self.atts["4"](run_seq(x, self.conv_patch))
        y = y + resize_trilinear(patch, y.shape[2:])
        return run_seq(y, self.conv_out)


class ChannelAttentionEnhancement(nn.Module):
    """SE-style channel gate from the spatial mean and max (`blocks.py:270-285`):
    sigmoid(fc(mean) + fc(max)), [B,C,1,1]. Keys: fc.0, fc.2 (bias-free)."""

    def __init__(self, c: int):
        super().__init__()
        self.fc = nn.Sequential(nn.Conv2d(c, c // 16, 1, bias=False), nn.ReLU(),
                                nn.Conv2d(c // 16, c, 1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        avg = x.mean(dim=(2, 3), keepdim=True)
        mx = x.amax(dim=(2, 3), keepdim=True)
        return torch.sigmoid(run_seq(avg, self.fc) + run_seq(mx, self.fc))


class SpatialAttentionExtractor(nn.Module):
    """A 7×7 conv over the channel mean and max, sigmoid (`blocks.py:288-300`):
    [B,1,H,W]. Key: samconv (bias-free)."""

    def __init__(self):
        super().__init__()
        self.samconv = nn.Conv2d(2, 1, 7, padding=3, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stats = torch.cat([x.mean(dim=1, keepdim=True), x.amax(dim=1, keepdim=True)], dim=1)
        return torch.sigmoid(run_conv(stats, self.samconv))


class EdgeNextConvEncoderPlain(nn.Module):
    """Norm-free ConvNeXt-style encoder (`blocks.py:303-320`): dw k×k, pw 4×,
    GELU, pw, LayerScale, plus x. Keys: dwconv, pwconv1, pwconv2, gamma."""

    def __init__(self, dim: int, kernel: int = 7):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, kernel, padding=kernel // 2, groups=dim)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = run_conv(x, self.dwconv).permute(0, 2, 3, 1)
        y = linear(gelu(linear(y, self.pwconv1)), self.pwconv2)
        return x + (y * self.gamma.to(y.dtype)).permute(0, 3, 1, 2)


class FSDispHead(nn.Module):
    """conv-relu, two plain EdgeNeXt encoders, conv → 1 channel
    (`blocks.py:323-336`). Keys: conv.{0,2,3,4}."""

    def __init__(self, dim: int = 128):
        super().__init__()
        self.conv = nn.Sequential(nn.Conv2d(dim, dim, 3, padding=1), nn.ReLU(),
                                  EdgeNextConvEncoderPlain(dim), EdgeNextConvEncoderPlain(dim),
                                  nn.Conv2d(dim, 1, 3, padding=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return run_seq(x, self.conv)


class RaftConvGRU(nn.Module):
    """z, r = sigmoid(conv(hx)), q = tanh(conv([r·h, x])), (1 - z)·h + z·q
    (`blocks.py:339-352`). Keys: convz, convr, convq."""

    def __init__(self, hidden_dim: int, input_dim: int, kernel: int = 3):
        super().__init__()
        ch = hidden_dim + input_dim
        self.convz = nn.Conv2d(ch, hidden_dim, kernel, padding=kernel // 2)
        self.convr = nn.Conv2d(ch, hidden_dim, kernel, padding=kernel // 2)
        self.convq = nn.Conv2d(ch, hidden_dim, kernel, padding=kernel // 2)

    def forward(self, h, x, hx):
        z = torch.sigmoid(run_conv(hx, self.convz))
        r = torch.sigmoid(run_conv(hx, self.convr))
        q = torch.tanh(run_conv(torch.cat([r * h, x], dim=1), self.convq))
        return (1 - z) * h + z * q


class SelectiveConvGRU(nn.Module):
    """A 1×1 and a 3×3 GRU blended by the attention map att
    (`blocks.py:355-374`): att·small + (1 - att)·large. Its inputs are cast to
    h's dtype, as flax's convs cast them. Keys: conv0.0, conv1.0, small_gru,
    large_gru."""

    def __init__(self, hidden_dim: int, input_dim: int):
        super().__init__()
        ch = hidden_dim + input_dim
        self.conv0 = nn.Sequential(nn.Conv2d(input_dim, input_dim, 3, padding=1), nn.ReLU())
        self.conv1 = nn.Sequential(nn.Conv2d(ch, ch, 3, padding=1), nn.ReLU())
        self.small_gru = RaftConvGRU(hidden_dim, input_dim, 1)
        self.large_gru = RaftConvGRU(hidden_dim, input_dim, 3)

    def forward(self, att, h, *xs):
        x = run_seq(torch.cat([t.to(h.dtype) for t in xs], dim=1), self.conv0)
        hx = run_seq(torch.cat([x, h], dim=1), self.conv1)
        return self.small_gru(h, x, hx) * att + self.large_gru(h, x, hx) * (1 - att)


class BasicSelectiveMultiUpdateBlock(nn.Module):
    """The selective GRU cascade over 1, 2 or 3 scales (`blocks.py:407-439`):
    gru16, gru08 (with the pooled and resized neighbours), the motion encoder
    on the lookups and the disparity, gru04, the disparity head and the
    superpixel mask features (0.25·relu(mask)). Keys: encoder, gru04, gru08,
    gru16 (as n_gru_layers has them), disp_head, mask.{0,2}."""

    def __init__(self, hidden_dim: int = 128, n_gru_layers: int = 3, cor_planes: int = 522,
                 motion_fuse_kernel: int = 3):
        super().__init__()
        hd, n = hidden_dim, n_gru_layers
        self.n_gru_layers = n
        self.encoder = BasicMotionEncoder(cor_planes, corr=(256, 256), disp=(64, 64), out=128,
                                          fuse_kernel=motion_fuse_kernel)
        self.gru04 = SelectiveConvGRU(hd, 2 * hd + hd * (n > 1))
        if n >= 2:
            self.gru08 = SelectiveConvGRU(hd, 2 * hd + hd * (n > 2))
        if n == 3:
            self.gru16 = SelectiveConvGRU(hd, 2 * hd)
        self.disp_head = FSDispHead(hd)
        self.mask = nn.Sequential(nn.Conv2d(hd, 64, 3, padding=1), nn.ReLU(),
                                  nn.Conv2d(64, 32, 3, padding=1))

    def forward(self, net, inp, corr, disp, att):
        net, n = list(net), self.n_gru_layers
        if n == 3:
            net[2] = self.gru16(att[2], net[2], inp[2], pool2x(net[1]))
        if n >= 2:
            extra = [pool2x(net[0])] + ([interp_to(net[2], net[1])] if n > 2 else [])
            net[1] = self.gru08(att[1], net[1], inp[1], *extra)
        motion = torch.cat([inp[0], self.encoder(disp, corr)], dim=1)
        extra = [interp_to(net[1], net[0])] if n > 1 else []
        net[0] = self.gru04(att[0], net[0], motion, *extra)
        delta = self.disp_head(net[0])
        mask = F.relu(run_seq(net[0], self.mask))
        return net, 0.25 * mask, delta


class ContextNetDino(MultiBasicEncoder):
    """IGEV's context encoder (BatchNorm, two outputs) with the frozen ViT's
    features concatenated at 1/4 and fused by `conv2` (a 3×3 conv, BatchNorm,
    leaky_relu) before the heads (`blocks.py:442-488`). Keys: those of
    `MultiBasicEncoder`, conv2.{conv,bn}."""

    def __init__(self, hidden_dims: Sequence[int] = (128, 128, 128), vit_feat_dim: int = 32):
        super().__init__([list(hidden_dims)] * 2)
        self.conv2 = BasicConvBN(128 + vit_feat_dim, 128, 3)

    def forward(self, x, vit_feat: Optional[torch.Tensor] = None):
        x = F.relu(apply_norm(run_conv(x, self.conv1), self.norm1))
        x = self.layer3(self.layer2(self.layer1(x)))
        x = self.conv2(torch.cat([x, vit_feat.to(x.dtype)], dim=1))
        out04 = [run_conv(head[0](x), head[1]) for head in self.outputs04]
        x = self.layer4(x)
        out08 = [run_conv(head[0](x), head[1]) for head in self.outputs08]
        x = self.layer5(x)
        out16 = [run_conv(x, head) for head in self.outputs16]
        return [out04, out08, out16]
