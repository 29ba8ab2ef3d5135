"""Depth metrics + CSV reporting.

Numpy implementations matching the reference metric definitions
(``utils/metrics.py:81-193``): masked means over valid pixels of AbsDiff,
AbsRel, SignedRel, MSE, and δ-outlier ratios at 1.25/1.25²/1.25³ (reported
as δ1/δ2/δ3 = 1 − outlier ratio, ``utils/metrics.py:24-27``).  The CSV
layout mirrors ``csv_saver`` (``utils/metrics.py:7-78``): per-scene rows +
overall mean/variance summary rows.  A torch backend (same formulas, masked
``where``-sums; the JAX package's jax backend) evaluates on the device.

A copy of the JAX package's ``evals/metrics.py``, with ``compute_all_torch``
in place of ``compute_all_jax``.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Optional, Sequence

import numpy as np


def _masked_mean(values: np.ndarray, valid: Optional[np.ndarray]) -> float:
    if valid is None:
        return float(np.mean(values))
    return float(np.mean(values[valid]))


def abs_diff(pred, gt, valid=None) -> float:
    return _masked_mean(np.abs(pred - gt), valid)


def abs_rel(pred, gt, valid=None) -> float:
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.abs(pred - gt) / gt
    return _masked_mean(np.where(np.isfinite(rel), rel, 0.0), valid)


def signed_rel(pred, gt, valid=None) -> float:
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = (pred - gt) / gt
    return _masked_mean(np.where(np.isfinite(rel), rel, 0.0), valid)


def mse(pred, gt, valid=None) -> float:
    return _masked_mean((pred - gt) ** 2, valid)


def delta_metric(pred, gt, threshold: float = 1.25, valid=None) -> float:
    """δ@threshold = fraction of valid pixels with max(p/g, g/p) <= threshold."""
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.maximum(pred / gt, gt / pred)
    outlier = np.where(ratio > threshold, 1.0, 0.0)
    return 1.0 - _masked_mean(outlier, valid)


def compute_all(pred, gt, valid=None) -> Dict[str, float]:
    return {
        "Delta1": delta_metric(pred, gt, 1.25, valid),
        "Delta2": delta_metric(pred, gt, 1.25**2, valid),
        "Delta3": delta_metric(pred, gt, 1.25**3, valid),
        "SignedRelative": signed_rel(pred, gt, valid),
        "AbsoluteError": abs_diff(pred, gt, valid),
        "AbsoluteRelative": abs_rel(pred, gt, valid),
        "MeanSquaredError": mse(pred, gt, valid),
    }


def compute_all_torch(pred, gt, valid=None) -> Dict:
    """Same metrics as 0-d fp32 tensors (masked ``where``-sums, the JAX
    ``compute_all_jax``), on whichever device ``pred`` lies; numpy inputs
    go to the CPU."""
    import torch

    pred = torch.as_tensor(pred).float()
    gt = torch.as_tensor(gt, device=pred.device).float()
    m = (torch.ones_like(pred) if valid is None
         else torch.as_tensor(valid, device=pred.device).float())
    n = m.sum().clamp_min(1.0)
    one = torch.ones_like(gt)
    inf = torch.full_like(gt, float("inf"))
    safe_gt = torch.where(gt != 0, gt, one)
    diff = pred - gt
    ratio = torch.maximum(
        torch.where(gt != 0, pred / safe_gt, inf),
        torch.where(pred != 0, gt / torch.where(pred != 0, pred, one), inf),
    )
    zero = torch.zeros_like(gt)

    def mmean(x):
        return (x * m).sum() / n

    return {
        "Delta1": 1.0 - mmean((ratio > 1.25).float()),
        "Delta2": 1.0 - mmean((ratio > 1.25**2).float()),
        "Delta3": 1.0 - mmean((ratio > 1.25**3).float()),
        "SignedRelative": mmean(torch.where(gt != 0, diff / safe_gt, zero)),
        "AbsoluteError": mmean(diff.abs()),
        "AbsoluteRelative": mmean(torch.where(gt != 0, diff.abs() / safe_gt, zero)),
        "MeanSquaredError": mmean(diff**2),
    }


HEADER = [
    "Scene",
    "#frames",
    "scale",
    "shift",
    "Delta1",
    "Delta2",
    "Delta3",
    "SignedRelative",
    "AbsoluteError",
    "AbsoluteRelative",
    "MeanSquaredError",
    "TAE",
]


class CsvSaver:
    """Per-scene metric CSV with mean/variance summary (ref
    ``utils/metrics.py:7-78``; this version adds a TAE column)."""

    def __init__(self, path: str):
        self.path = path
        self._initialised = False

    def _ensure_header(self):
        if self._initialised:
            return
        if os.path.isfile(self.path):
            raise FileExistsError(f"refusing to overwrite existing CSV: {self.path}")
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "w", newline="") as f:
            csv.writer(f).writerow(HEADER)
        self._initialised = True

    def add_scene(
        self,
        scene: str,
        metrics: Dict[str, float],
        scale: float,
        shift: float,
        n_frames: Optional[int] = None,
        tae: Optional[float] = None,
    ):
        self._ensure_header()
        row = [scene, n_frames if n_frames is not None else "NotSaved", scale, shift]
        row += [metrics[k] for k in HEADER[4:-1]]
        row += [tae if tae is not None else ""]
        with open(self.path, "a", newline="") as f:
            csv.writer(f).writerow(row)

    def summarize(self, extra_header: Optional[Sequence] = None, extra_row: Optional[Sequence] = None):
        # all scenes may have been skipped (e.g. streaming on short clips) —
        # still emit a valid CSV with header + summary rows
        self._ensure_header()
        data: Dict[str, list] = {k: [] for k in HEADER}
        with open(self.path, newline="") as f:
            for row in csv.DictReader(f):
                for k in HEADER:
                    data[k].append(row.get(k, ""))
        mean_row, var_row = ["Overall Mean"], ["Overall Variance"]
        for k in HEADER[1:]:
            vals = [v for v in data[k] if v not in ("", "NotSaved")]
            try:
                vals = [float(v) for v in vals]
                mean_row.append(np.mean(vals) if vals else "--")
                var_row.append(np.var(vals) if vals else "--")
            except ValueError:
                mean_row.append("--")
                var_row.append("--")
        with open(self.path, "a", newline="") as f:
            w = csv.writer(f)
            w.writerow([])
            w.writerow(mean_row)
            w.writerow(var_row)
            if extra_header is not None and extra_row is not None:
                w.writerow([])
                w.writerow(extra_header)
                w.writerow(extra_row)
