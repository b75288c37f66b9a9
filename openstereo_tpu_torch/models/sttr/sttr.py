"""STTR, NCHW (counterpart of `openstereo_tpu/models/sttr/sttr.py`).

SPP backbone and DenseNet tokenizer → per-pixel tokens at full resolution,
sampled every DOWNSAMPLE pixels; alternating self/cross epipolar attention
(K4 on the kernel path, in training through its trainable form); optimal
transport (log-space Sinkhorn, 10 iterations, learned dustbin `phi`) in f32;
3-px window regression around the argmax; nearest upsample and the context
adjustment layer. In training the forward adds the transport plan's
response at the ground-truth match and, given occlusion masks, the dustbin
responses, which `get_loss` reads (rr + l1_raw + l1 + occ_be).

Attribute names follow the reference STTR state_dict (`backbone.`,
`tokenizer.`, `transformer.`, `regression_head.phi`, `regression_head.cal.`),
so a reference `.pth` loads as it is.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..layers import head_dtype
from ..losses import masked_mean, smooth_l1
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


def sample_1d_linear(source: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Linear sample along the last axis at clamped neighbours (`sttr.py:76-88`):
    source [..., L], points [...] → [...]. The weights are points − lo and
    1 − (points − lo), as the JAX package takes them, also where the clamp
    moves lo."""
    n = source.shape[-1]
    lo = torch.floor(points).clamp(0, n - 1)
    hi = torch.ceil(points).clamp(0, n - 1)
    w_hi = points - lo
    g_lo = torch.gather(source, -1, lo.long()[..., None])[..., 0]
    g_hi = torch.gather(source, -1, hi.long()[..., None])[..., 0]
    return g_lo * (1.0 - w_hi) + g_hi * w_hi


def low_res_disp(attn: torch.Tensor, occ_mask: Optional[torch.Tensor] = None,
                 best: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """3-px window regression around the argmax (`sttr.py:91-118`).

    attn [N,H,W,W] (dustbins stripped) → (disp [N,H,W], matched attention
    [N,H,W]). The argmax takes the first maximum; a window whose mass is
    below 0.1 (or, given `occ_mask`, an occluded pixel) is not renormalised.
    `best` [N,H,W,1], if given, replaces the argmax: two evaluations of one
    step then regress the same windows, where a near-tie could otherwise
    move a window between them.
    """
    w = attn.shape[-1]
    if best is None:
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
    'disp_pred_low_res' [B,H',W']}; in training with data['disp'] also
    'gt_response' [B,H',W'] and, with data['occ_mask'],
    'gt_response_occ_left' / '_right' [B,H',W'].

    data['left'] / data['right']: [B,3,H,W] normalized images; 'disp',
    'occ_mask', 'occ_mask_right' [B,H,W]. `dtype` is the compute dtype (bf16
    on the inference path, f32 in the STTR config's training); parameters
    stay f32, and the optimal transport and regression run in at least f32.
    VALIDATION_MAX_DISP is read by `get_loss`; PX_ERROR_THRESHOLD by nothing.
    """

    def __init__(self, max_disp: int = 192, channel_dim: int = 128, nheads: int = 8,
                 num_attn_layers: int = 6, downsample: int = 3, cal_num_blocks: int = 8,
                 cal_feat_dim: int = 16, cal_expansion_ratio: int = 4,
                 validation_max_disp: int = 192, px_error_threshold: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.max_disp, self.downsample, self.dtype = max_disp, downsample, dtype
        self.validation_max_disp = validation_max_disp
        self.backbone = SppBackboneIN()
        self.tokenizer = Tokenizer(channel_dim)
        self.transformer = Transformer(channel_dim, nheads, num_attn_layers)
        self.regression_head = RegressionHead(cal_num_blocks, cal_feat_dim, cal_expansion_ratio)

    def forward(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
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
        out = {"disp_pred": disp[:, 0] * std_d + mean_d, "occ_pred": occ[:, 0],
               "disp_pred_low_res": disp_low * scale}
        if self.training and "disp" in data:
            # the plan's response at the ground-truth match (`sttr.py:212-224`),
            # at the sampled tokens' full-resolution columns
            disp_s = data["disp"][:, off::step, off::step]
            pos_l = torch.arange(disp_low.shape[-1], dtype=torch.float32,
                                 device=left.device) * step + off
            target = (pos_l - disp_s) / scale
            out["gt_response"] = sample_1d_linear(attn_ot[..., :-1, :-1], target)
            if occ_mask is not None:
                out["gt_response_occ_left"] = attn_ot[..., :-1, -1]
                out["gt_response_occ_right"] = attn_ot[..., -1, :-1]
        return out

    def get_loss(self, pred: Dict[str, torch.Tensor], data: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """rr + l1_raw + l1 + occ_be, each weighted 1.0 (`sttr.py:226-262`).

        rr: −log(response + 1e-6) at the ground-truth match of every valid
        sampled pixel and, given the occlusion masks, at the dustbins of the
        occluded ones; l1_raw and l1: smooth-L1 of the low-resolution and the
        final disparity over the valid pixels; occ_be: binary cross-entropy
        of the occlusion head. A mean over an empty mask is 0.
        """
        ds = self.downsample
        off = ds // 2 if ds > 0 else 0
        sub = lambda x: x[:, off::ds, off::ds] if ds > 0 else x  # noqa: E731
        disp = data["disp"]
        invalid = (disp <= 0.0) | (disp >= self.validation_max_disp)
        invalid_s = sub(invalid)
        losses = {}
        valid_s = (~invalid_s).to(head_dtype(self.dtype))
        rr_sum = (-torch.log(pred["gt_response"] + _EPS) * valid_s).sum()
        rr_cnt = valid_s.sum()
        if "gt_response_occ_left" in pred and "occ_mask" in data:
            for side, mask in (("left", data["occ_mask"]), ("right", data["occ_mask_right"])):
                occ = sub(mask) > 0.5
                rr_sum = rr_sum + (-torch.log(pred[f"gt_response_occ_{side}"] + _EPS) * occ).sum()
                rr_cnt = rr_cnt + occ.sum()
        losses["rr"] = rr_sum / rr_cnt.clamp(min=1.0)
        losses["l1_raw"] = masked_mean(smooth_l1(pred["disp_pred_low_res"], sub(disp)), ~invalid_s)
        losses["l1"] = masked_mean(smooth_l1(pred["disp_pred"], disp), ~invalid)
        occ_pred = pred["occ_pred"]
        occ = data["occ_mask"] > 0.5
        be_sum = ((-torch.log(occ_pred + _EPS) * occ).sum()
                  + (-torch.log(1.0 - occ_pred + _EPS) * ~invalid).sum())
        be_cnt = (occ.sum() + (~invalid).sum()).to(be_sum.dtype)
        losses["occ_be"] = be_sum / be_cnt.clamp(min=1.0)
        total = losses["rr"] + losses["l1_raw"] + losses["l1"] + losses["occ_be"]
        return total, {"loss_disp": total, **{f"loss_{k}": v for k, v in losses.items()}}
