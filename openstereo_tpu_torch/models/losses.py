"""Loss primitives: the port's copy of `openstereo_tpu/models/losses.py` (whole file).

Masked losses reduce with a mask instead of boolean indexing, as the JAX
package does, so a loss over an empty mask is 0 (`losses.py:20-24`), where
the reference's `F.smooth_l1_loss(pred[mask], gt[mask])` gives NaN.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Elementwise smooth-L1 (`losses.py:14`, F.smooth_l1_loss's beta=1 form)."""
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of `values` where `mask`; 0 if the mask is empty (`losses.py:20`)."""
    mask = mask.to(values.dtype)
    return (values * mask).sum() / mask.sum().clamp(min=1.0)


def masked_smooth_l1(pred, target, mask) -> torch.Tensor:
    return masked_mean(smooth_l1(pred, target), mask)


def masked_l1(pred, target, mask) -> torch.Tensor:
    return masked_mean((pred - target).abs(), mask)


def disp_valid_mask(disp_gt: torch.Tensor, max_disp: float) -> torch.Tensor:
    """0 < gt < max_disp (`losses.py:35`)."""
    return (disp_gt > 0) & (disp_gt < max_disp)


def weighted_heads_loss(preds, gt: torch.Tensor, max_disp: float, weights) -> torch.Tensor:
    """Σ weight · masked smooth-L1 of each head's disparity over 0 < gt <
    max_disp, summed from 0 in head order: the `get_loss` of GwcNet, PSMNet,
    CoEx and MSNet (`gwcnet.py:188-194`, `psmnet.py:213-219`, `coex.py:
    187-196`, `msnet.py:181-186`)."""
    mask = disp_valid_mask(gt, max_disp)
    loss = 0.0
    for p, wgt in zip(preds, weights):
        loss = loss + wgt * masked_smooth_l1(p, gt, mask)
    return loss


FLOW_PYRAMID_WEIGHTS = (0.32, 0.16, 0.08, 0.04, 0.02, 0.01, 0.005)


def flow_pyramid_loss(pyramids, gt: torch.Tensor, max_disp: float,
                      weights=FLOW_PYRAMID_WEIGHTS) -> torch.Tensor:
    """FADNet's loss (`fadnet.py:216-227`): over each pyramid of flows
    [B,1,H/2^i,W/2^i] (full resolution first), Σ weight_i · masked smooth-L1
    against the ground truth [B,H,W] average-pooled 2×2 i times (VALID, an odd
    row or column dropped, as `nn.avg_pool`), masked by 0 < target < max_disp
    at that scale; summed from 0, pyramid by pyramid."""
    loss = 0.0
    for flows in pyramids:
        target = gt[:, None]
        for i, (flow, wgt) in enumerate(zip(flows, weights)):
            if i > 0:
                target = F.avg_pool2d(target, 2)
            loss = loss + wgt * masked_smooth_l1(flow, target, disp_valid_mask(target, max_disp))
    return loss


# Classification losses (`losses.py:46-81`), mean-reduced.

def bce(probs: torch.Tensor, targets: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Binary cross-entropy on probabilities (post-sigmoid)."""
    p = probs.clamp(eps, 1.0 - eps)
    return -(targets * torch.log(p) + (1.0 - targets) * torch.log1p(-p)).mean()


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """max(x,0) - x·t + log(1+e^-|x|)."""
    return (logits.clamp(min=0.0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs()))).mean()


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """Softmax cross-entropy over `axis`; integer class targets (logits'
    shape without `axis`) or a soft distribution of logits' shape."""
    logp = logits - torch.logsumexp(logits, dim=axis, keepdim=True)
    if targets.shape == logits.shape:
        return -(targets * logp).sum(dim=axis).mean()
    return -torch.gather(logp, axis, targets.long().unsqueeze(axis)).mean()


def kl_div(log_pred: torch.Tensor, targets: torch.Tensor, reduction: str = "mean",
           eps: float = 1e-12) -> torch.Tensor:
    """KL(targets ‖ exp(log_pred)) pointwise, log_pred already log-probabilities."""
    pointwise = targets * (torch.log(targets.clamp(min=eps)) - log_pred)
    pointwise = torch.where(targets > 0, pointwise, torch.zeros_like(pointwise))
    if reduction == "mean":
        return pointwise.mean()
    if reduction == "batchmean":
        return pointwise.sum() / log_pred.shape[0]
    return pointwise
