"""Training losses for temporal fine-tuning (the JAX package's
``train/losses.py``): a scale-shift-invariant disparity loss plus temporal
gradient matching (TGM), which penalises frame-to-frame disparity changes
that disagree with the ground truth.  All reductions are mask-weighted and
fp32.  ``total`` (data-parallel training) sums each mask-weight
denominator over the ranks, so that each rank's loss is its share of the
loss of the whole batch."""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def masked_scale_shift(pred, target, mask, eps: float = 1e-6):
    """Closed-form per-frame (s, t) minimising ``||m·(s·pred + t − target)||²``
    over the trailing spatial axes.  Shapes ``(..., H, W)``; returns
    broadcastable ``(..., 1, 1)`` s and t (1 and 0 where the fit is
    degenerate)."""
    pred, target, m = pred.float(), target.float(), mask.float()
    ax = (-2, -1)
    a00 = (m * pred * pred).sum(ax, keepdim=True)
    a01 = (m * pred).sum(ax, keepdim=True)
    a11 = m.sum(ax, keepdim=True)
    b0 = (m * pred * target).sum(ax, keepdim=True)
    b1 = (m * target).sum(ax, keepdim=True)
    det = a00 * a11 - a01 * a01
    safe = det.abs() > eps
    det = torch.where(safe, det, torch.ones_like(det))
    s = torch.where(safe, (a11 * b0 - a01 * b1) / det, torch.ones_like(det))
    t = torch.where(safe, (-a01 * b0 + a00 * b1) / det, torch.zeros_like(det))
    return s, t


def _den(weights: torch.Tensor, total) -> torch.Tensor:
    den = weights.sum()
    return (den if total is None else total(den)).clamp(min=1.0)


def ssi_loss(pred, target, mask, total=None) -> torch.Tensor:
    """Scale-shift-invariant MAE on disparity: per-frame align, then
    mask-weighted L1.  ``pred, target, mask: (B, T, H, W)``."""
    s, t = masked_scale_shift(pred, target, mask)
    m = mask.float()
    err = (pred.float() * s + t - target.float()).abs() * m
    return err.sum() / _den(m, total)


def tgm_loss(pred, target, mask, total=None) -> torch.Tensor:
    """Temporal gradient matching: L1 between consecutive-frame disparity
    deltas of the (per-frame aligned) prediction and the target, on pixels
    valid in both frames."""
    s, t = masked_scale_shift(pred, target, mask)
    aligned = pred.float() * s + t
    tgt, m = target.float(), mask.float()
    dp = aligned[:, 1:] - aligned[:, :-1]
    dg = tgt[:, 1:] - tgt[:, :-1]
    mm = m[:, 1:] * m[:, :-1]
    return ((dp - dg).abs() * mm).sum() / _den(mm, total)


def video_depth_loss(pred, target, mask, tgm_weight: float = 10.0,
                     total=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    l_ssi = ssi_loss(pred, target, mask, total)
    l_tgm = tgm_loss(pred, target, mask, total)
    total = l_ssi + tgm_weight * l_tgm
    return total, {"loss": total, "ssi": l_ssi, "tgm": l_tgm}
