"""Stereo metrics over a [B,H,W] batch: the port's copy of
`openstereo_tpu/evaluation/metrics.py:19-81`.

Per image (`compute_metrics`, [B] each): EPE, D1 (% of valid pixels with
|err| > 3 and > 5 % of gt), bad-τ (% with |err| > τ). The scalar forms
weight every valid pixel of the batch equally. An empty mask gives 0.
"""

from __future__ import annotations

import torch


def _masked_image_mean(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B,H,W] → [B]: the mean over each image's valid pixels."""
    m = mask.to(value.dtype)
    denom = m.sum(dim=(1, 2))
    total = (value * m).sum(dim=(1, 2))
    return torch.where(denom > 0, total / denom.clamp(min=1.0), torch.zeros_like(total))


def epe_metric(disp_pred, disp_gt, mask) -> torch.Tensor:
    return _masked_image_mean((disp_pred - disp_gt).abs(), mask)


def d1_metric(disp_pred, disp_gt, mask) -> torch.Tensor:
    err = (disp_pred - disp_gt).abs()
    bad = (err > 3.0) & (err > 0.05 * disp_gt.abs())
    return _masked_image_mean(bad.to(disp_pred.dtype), mask) * 100.0


def threshold_metric(disp_pred, disp_gt, mask, threshold: float) -> torch.Tensor:
    bad = (disp_pred - disp_gt).abs() > threshold
    return _masked_image_mean(bad.to(disp_pred.dtype), mask) * 100.0


METRIC_FNS = {
    "epe": epe_metric,
    "d1_all": d1_metric,
    "thres_1": lambda p, g, m: threshold_metric(p, g, m, 1.0),
    "thres_2": lambda p, g, m: threshold_metric(p, g, m, 2.0),
    "thres_3": lambda p, g, m: threshold_metric(p, g, m, 3.0),
}


def compute_metrics(disp_pred, disp_gt, mask,
                    names=("epe", "d1_all", "thres_1", "thres_2", "thres_3")):
    """Per-image metric dict {name: [B]}."""
    return {name: METRIC_FNS[name](disp_pred, disp_gt, mask) for name in names}


def _masked_batch_mean(value: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(value.dtype)
    denom = m.sum()
    return torch.where(denom > 0, (value * m).sum() / denom.clamp(min=1.0),
                       torch.zeros_like(denom))


def epe_metric_scalar(disp_pred, disp_gt, mask) -> torch.Tensor:
    return _masked_batch_mean((disp_pred - disp_gt).abs(), mask)


def d1_metric_scalar(disp_pred, disp_gt, mask) -> torch.Tensor:
    err = (disp_pred - disp_gt).abs()
    bad = (err > 3.0) & (err > 0.05 * disp_gt.abs())
    return _masked_batch_mean(bad.to(disp_pred.dtype), mask) * 100.0


def threshold_metric_scalar(disp_pred, disp_gt, mask, threshold: float) -> torch.Tensor:
    bad = (disp_pred - disp_gt).abs() > threshold
    return _masked_batch_mean(bad.to(disp_pred.dtype), mask) * 100.0
