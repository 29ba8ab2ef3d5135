"""Scale/shift alignment math: the closed-form least-squares fit of
``pred·s + t ≈ target`` on the host (numpy, the window stitch and the
streaming transition phase) and on the device (torch, the aligned
streaming steps), and the overlap cross-fade weights."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def compute_scale_and_shift(
    prediction: np.ndarray, target: np.ndarray, mask: np.ndarray | None = None,
    scale_only: bool = False,
) -> Tuple[float, float]:
    """Least-squares (s, t) minimizing ``||mask·(s·pred + t − target)||²``."""
    prediction = np.asarray(prediction, dtype=np.float32)
    target = np.asarray(target, dtype=np.float32)
    if mask is None:
        mask = np.ones_like(prediction)
    mask = np.asarray(mask, dtype=np.float32)

    a_00 = np.sum(mask * prediction * prediction)
    a_01 = np.sum(mask * prediction)
    a_11 = np.sum(mask)
    b_0 = np.sum(mask * prediction * target)

    if scale_only:
        return float(b_0 / (a_00 + 1e-6)), 0.0

    b_1 = np.sum(mask * target)
    det = a_00 * a_11 - a_01 * a_01
    if det == 0:
        return 1.0, 0.0
    s = (a_11 * b_0 - a_01 * b_1) / det
    t = (-a_01 * b_0 + a_00 * b_1) / det
    return float(s), float(t)


def compute_scale_and_shift_torch(prediction: torch.Tensor, target: torch.Tensor,
                                  mask: torch.Tensor | None = None):
    """The same fit on the device (JAX ``compute_scale_and_shift_jax``):
    fp32 moments, ``(1, 0)`` where the system is singular; returns 0-d
    tensors ``(s, t)`` without a host round trip."""
    pred, tgt = prediction.float(), target.float()
    m = torch.ones_like(pred) if mask is None else mask.float()
    a_00, a_01, a_11 = (m * pred * pred).sum(), (m * pred).sum(), m.sum()
    b_0, b_1 = (m * pred * tgt).sum(), (m * tgt).sum()
    det = a_00 * a_11 - a_01 * a_01
    ok = det != 0
    s = torch.where(ok, (a_11 * b_0 - a_01 * b_1) / det, torch.ones_like(det))
    t = torch.where(ok, (-a_01 * b_0 + a_00 * b_1) / det, torch.zeros_like(det))
    return s, t


def interpolation_weights(n: int) -> np.ndarray:
    """Cross-fade *post* weights for the n-frame overlap: 0 … 1 linearly."""
    if n == 1:
        return np.array([1.0], dtype=np.float32)
    step = 1.0 / (n - 1)
    return np.array([0.0] + [i * step for i in range(1, n - 1)] + [1.0], dtype=np.float32)
