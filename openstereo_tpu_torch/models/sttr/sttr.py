"""STTR eval, NCHW (counterpart of `openstereo_tpu/models/sttr/sttr.py`).

SPP backbone and DenseNet tokenizer → per-pixel tokens at full resolution,
sampled every DOWNSAMPLE pixels; alternating self/cross epipolar attention
(K4 on the kernel path); optimal transport (log-space Sinkhorn, 10
iterations, learned dustbin `phi`) in f32; 3-px window regression around the
argmax; nearest upsample and the context adjustment layer.

Attribute names follow the reference STTR state_dict (`backbone.`,
`tokenizer.`, `transformer.`, `regression_head.phi`, `regression_head.cal.`),
so a reference `.pth` loads as it is. The train outputs, `get_loss` and K4's
backward are ROADMAP item 8.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..layers import head_dtype
from .blocks import ContextAdjustmentLayer, SppBackboneIN, Tokenizer
from .transformer import Transformer

_EPS = 1e-6


def sinkhorn_log(attn: torch.Tensor, log_mu: torch.Tensor, log_nu: torch.Tensor,
                 iters: int) -> torch.Tensor:
    """Log-space Sinkhorn (`sttr.py:40-54`)."""
    u, v = torch.zeros_like(log_mu), torch.zeros_like(log_nu)
    for _ in range(iters):
        v = log_nu - torch.logsumexp(attn + u[..., None], dim=-2)
        u = log_mu - torch.logsumexp(attn + v[..., None, :], dim=-1)
    return attn + u[..., None] + v[..., None, :]


def optimal_transport(attn: torch.Tensor, phi: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Dustbins + Sinkhorn + renormalisation (`sttr.py:57-73`), in at least f32.

    attn [N,H,W,W] → transport plan [N,H,W+1,W+1], scaled by 2W.
    """
    n, h, w, _ = attn.shape
    attn = attn.to(head_dtype(attn.dtype))
    phi = phi.to(attn.dtype)
    sim = torch.cat([attn, phi.expand(n, h, w, 1)], dim=-1)
    sim = torch.cat([sim, phi.expand(n, h, 1, w + 1)], dim=-2)
    marginal = torch.cat([torch.ones(w, dtype=attn.dtype, device=attn.device),
                          torch.full((1,), float(w), dtype=attn.dtype, device=attn.device)])
    log_m = torch.log(marginal / (2.0 * w))
    log_mu = log_m.expand(n, h, w + 1)
    out = sinkhorn_log(sim, log_mu, log_mu, iters)
    return torch.exp(out + np.log(2.0 * w))


def low_res_disp(attn: torch.Tensor, occ_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """3-px window regression around the argmax (`sttr.py:91-118`).

    attn [N,H,W,W] (dustbins stripped) → (disp [N,H,W], matched attention
    [N,H,W]). The argmax takes the first maximum; a window whose mass is
    below 0.1 (or, given `occ_mask`, an occluded pixel) is not renormalised.
    """
    w = attn.shape[-1]
    best = attn.argmax(dim=-1, keepdim=True)
    window = torch.cat([best - 1, best, best + 1], dim=-1) + 1  # into the padded axis
    padded = torch.nn.functional.pad(attn, (1, 1))
    attn_rw = torch.gather(padded, -1, window)
    norm = attn_rw.sum(dim=-1, keepdim=True)
    if occ_mask is None:
        norm = torch.where(norm < 0.1, torch.ones_like(norm), norm)
    else:
        norm = torch.where(occ_mask[..., None] > 0.5, torch.ones_like(norm), norm)
    attn_rw = attn_rw / norm
    pos = torch.arange(w, dtype=attn.dtype, device=attn.device)
    shift = torch.clamp(pos[:, None] - pos[None, :], min=0.0)  # [W,W]: max(i - j, 0)
    shift = torch.nn.functional.pad(shift, (1, 1)).expand(*attn.shape[:-1], w + 2)
    pos_rw = torch.gather(shift, -1, window)
    return (attn_rw * pos_rw).sum(dim=-1), norm[..., 0]


def nearest_index(n_out: int, n_in: int) -> np.ndarray:
    """floor(i · n_in / n_out) in f32, the index `sttr.py:191-194` takes
    (torch's nearest rule, computed as the JAX package computes it)."""
    return np.floor(np.arange(n_out, dtype=np.float32) * np.float32(n_in / n_out)).astype(np.int64)


class RegressionHead(nn.Module):
    """The reference's regression head: the dustbin cost `phi` and `cal`."""

    def __init__(self, cal_num_blocks: int, cal_feat_dim: int, cal_expansion_ratio: int):
        super().__init__()
        self.phi = nn.Parameter(torch.tensor(0.0))
        self.cal = ContextAdjustmentLayer(cal_num_blocks, cal_feat_dim, cal_expansion_ratio)


class STTR(nn.Module):
    """forward(data) → {'disp_pred' [B,H,W], 'occ_pred' [B,H,W],
    'disp_pred_low_res' [B,H',W']} (eval).

    data['left'] / data['right']: [B,3,H,W] normalized images. `dtype` is the
    compute dtype (bf16 on the main path); parameters stay f32, and the
    optimal transport and regression run in at least f32.
    VALIDATION_MAX_DISP and PX_ERROR_THRESHOLD are read by training only.
    """

    def __init__(self, max_disp: int = 192, channel_dim: int = 128, nheads: int = 8,
                 num_attn_layers: int = 6, downsample: int = 3, cal_num_blocks: int = 8,
                 cal_feat_dim: int = 16, cal_expansion_ratio: int = 4,
                 validation_max_disp: int = 192, px_error_threshold: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.max_disp, self.downsample, self.dtype = max_disp, downsample, dtype
        self.backbone = SppBackboneIN()
        self.tokenizer = Tokenizer(channel_dim)
        self.transformer = Transformer(channel_dim, nheads, num_attn_layers)
        self.regression_head = RegressionHead(cal_num_blocks, cal_feat_dim, cal_expansion_ratio)

    def forward(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self.training:
            raise NotImplementedError("STTR training is ROADMAP item 8")
        left = data["left"]
        bs, _, h, w = left.shape
        stacked = torch.cat([left, data["right"]], dim=0).to(self.dtype)
        tokens = self.tokenizer(self.backbone(stacked))  # one pass over both views
        feat_left, feat_right = tokens[:bs], tokens[bs:]

        ds = self.downsample
        off = ds // 2 if ds > 0 else 0
        step = max(ds, 1)
        feat_left = feat_left[:, :, off::step, off::step]
        feat_right = feat_right[:, :, off::step, off::step]
        scale = w / feat_left.shape[-1] if ds > 0 else 1.0

        attn_raw = self.transformer(feat_left, feat_right, pos_scale=scale)  # [N,H',W',W']
        attn_ot = optimal_transport(attn_raw, self.regression_head.phi, iters=10)
        occ_mask = data.get("occ_mask")
        if occ_mask is not None:
            occ_mask = occ_mask[:, off::step, off::step]
        disp_low, matched = low_res_disp(attn_ot[..., :-1, :-1], occ_mask)
        occ_low = 1.0 - matched

        hi = torch.from_numpy(nearest_index(h, disp_low.shape[1])).to(left.device)
        wi = torch.from_numpy(nearest_index(w, disp_low.shape[2])).to(left.device)
        nearest_up = lambda x: x[:, hi][:, :, wi]  # noqa: E731
        disp_up = nearest_up(disp_low * scale)
        occ_up = nearest_up(occ_low)

        mean_d = disp_up.mean()
        std_d = disp_up.std(unbiased=True) + _EPS
        disp_n = ((disp_up - mean_d) / std_d)[:, None]
        occ_n = ((occ_up - 0.5) / 0.5)[:, None]
        disp, occ = self.regression_head.cal(disp_n, occ_n, left, self.dtype)
        return {"disp_pred": disp[:, 0] * std_d + mean_d, "occ_pred": occ[:, 0],
                "disp_pred_low_res": disp_low * scale}
