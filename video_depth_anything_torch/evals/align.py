"""Prediction→ground-truth alignment.

Two layers, mirroring the reference's ``utils/align.py``:

* the *used* eval path (``fit_inverse_alignment`` / ``align_prediction``,
  ref ``utils/align.py:151-218``): the model's scale/shift-invariant
  inverse depth is fitted to inverse ground truth by ``np.linalg.lstsq``,
  clipped to [0, 1], inverted, and clipped to the dataset's max depth;
* the general ``DepthMap`` / ``Alignment`` framework (ref
  ``utils/align.py:17-190``) that ``compare.py``-style workflows build on:
  depth maps of either parameterization (depth or inverse depth) with
  sparse validity masks and optional known metric scale/shift, automatic
  parameterization reconciliation before fitting, and a pure-scale fit
  when both shifts are already known.

A copy of the JAX package's ``evals/align.py`` (numpy host code).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np


def fit_inverse_alignment(
    prediction: np.ndarray, ground_truth: np.ndarray, valid: np.ndarray
) -> Tuple[float, float]:
    """lstsq fit of ``c0·pred + c1 ≈ 1/gt`` over valid pixels; returns the
    reference's (scale, shift) = (1/c0, −c1/c0) parameterization
    (``utils/align.py:151-160``)."""
    with np.errstate(divide="ignore"):
        gt_inv = 1.0 / ground_truth
    mask = valid & np.isfinite(gt_inv)
    x = prediction[mask].astype(np.float64)[:, None]
    x = np.concatenate([x, np.ones_like(x)], axis=-1)
    coeffs, _, _, _ = np.linalg.lstsq(x, gt_inv[mask].astype(np.float64), rcond=None)
    if np.abs(coeffs[0]) <= 0.0:
        return float("inf"), 0.0
    scale = 1.0 / coeffs[0]
    shift = -coeffs[1] / coeffs[0]
    return float(scale), float(shift)


def align_prediction(
    prediction: np.ndarray,
    ground_truth: np.ndarray,
    valid: np.ndarray,
    max_depth: float = 80.0,
) -> Tuple[np.ndarray, float, float]:
    """Inverse-depth prediction → metric depth aligned to GT
    (ref ``utils/align.py:192-218``): fit in inverse space, clip the aligned
    inverse depth to [0, 1], replace exact zeros with 1e-4, invert, clip to
    ``max_depth``."""
    scale, shift = fit_inverse_alignment(prediction, ground_truth, valid)
    aligned = np.clip((prediction - shift) / scale, 0.0, 1.0)
    aligned = np.where(aligned == 0.0, 1e-4, aligned)
    aligned = np.clip(1.0 / aligned, 0.0, max_depth)
    return aligned, scale, shift


# ---------------------------------------------------------------------------
# DepthMap / Alignment framework (ref utils/align.py:17-190)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DepthMap:
    """A (possibly sparse) depth map in either parameterization.

    ``values``: (H, W) float array; ``valid``: boolean mask of usable
    pixels (``None`` → all valid).  ``inverse=True`` means ``values`` hold
    inverse depth.  ``scale``/``shift`` (optional) relate the stored values
    to metric (inverse) depth via ``metric = (values − shift) / scale``;
    ``value_range`` optionally records the clip range used for storage or
    visualization (ref utils/align.py:18-50).
    """

    values: np.ndarray
    inverse: bool
    valid: Optional[np.ndarray] = None
    value_range: Optional[Tuple[float, float]] = None
    scale: Optional[float] = None
    shift: Optional[float] = None

    def mask(self) -> np.ndarray:
        if self.valid is None:
            return np.ones(self.values.shape, dtype=bool)
        return self.valid.astype(bool)

    def is_metric(self) -> bool:
        return self.scale is not None and self.shift is not None

    def invert(self) -> "DepthMap":
        """Flip the parameterization (depth ⇄ inverse depth).  Only valid
        for shift-free maps — ``1/(s·x)`` is a pure rescale, but a shifted
        map has no reciprocal in the other parameterization
        (ref utils/align.py:72-89)."""
        if self.shift not in (0, 0.0):
            # shift=None also raises (matching the reference, which refuses
            # parameterization conversion unless the shift is known to be
            # exactly 0): 1/(s·x+t) is not affine in 1/x, so inverting a
            # map whose shift is unknown would be silently wrong whenever
            # the true shift is nonzero.
            raise ValueError(
                f"cannot invert a depth map with shift={self.shift}"
            )
        with np.errstate(divide="ignore"):
            vals = 1.0 / self.values
        valid = self.mask() & np.isfinite(vals)
        rng = None
        if self.value_range is not None:
            lo, hi = self.value_range
            rng = (
                1.0 / hi if hi != 0 else lo / 1024.0,
                1.0 / lo if lo != 0 else hi / 1024.0,
            )
        return DepthMap(
            vals,
            inverse=not self.inverse,
            valid=valid,
            value_range=rng,
            scale=None if self.scale is None else 1.0 / self.scale,
            shift=0.0,
        )

    def metric_depth(self) -> np.ndarray:
        """Metric depth (meters) from a map with known scale/shift;
        inverse maps are converted (ref utils/align.py:94-100)."""
        if not self.is_metric():
            raise ValueError("scale/shift unknown — not a metric depth map")
        if self.inverse:
            with np.errstate(divide="ignore"):
                return self.scale / (self.values - self.shift)
        return (self.values - self.shift) / self.scale


@dataclasses.dataclass(frozen=True)
class Alignment:
    """A fitted ``(values − shift) / scale`` mapping in a fixed
    parameterization, carrying the ground truth's metric scale/shift so the
    aligned map becomes metric (ref utils/align.py:103-134)."""

    inverse: bool
    scale: float
    shift: float
    metric_scale: Optional[float] = None
    metric_shift: Optional[float] = None

    def apply(self, depth_map: DepthMap) -> DepthMap:
        if depth_map.inverse != self.inverse:
            depth_map = depth_map.invert()  # raises on shifted maps
        vals = (depth_map.values - self.shift) / self.scale
        rng = None
        if depth_map.value_range is not None:
            lo, hi = depth_map.value_range
            rng = ((lo - self.shift) / self.scale, (hi - self.shift) / self.scale)
        return DepthMap(
            vals,
            inverse=self.inverse,
            valid=depth_map.valid,
            value_range=rng,
            scale=self.metric_scale,
            shift=self.metric_shift,
        )

    def apply_all(
        self, depth_maps: Iterable[Optional[DepthMap]]
    ) -> Iterator[Optional[DepthMap]]:
        for dm in depth_maps:
            yield None if dm is None else self.apply(dm)


def _joint_mask(a: DepthMap, b: DepthMap) -> np.ndarray:
    return a.mask() & b.mask()


def frame_align_lstsq(prediction: DepthMap, ground_truth: DepthMap) -> Alignment:
    """Least-squares ``(prediction − shift)/scale ≈ ground_truth`` over the
    joint valid mask (ref utils/align.py:172-190).

    The fit runs in the *prediction's* parameterization — ground truth is
    inverted to match when needed (only possible for shift-free GT).  When
    both shifts are already known, only the scale is fitted and the
    aligning shift follows from the known offsets.
    """
    if prediction.inverse != ground_truth.inverse:
        ground_truth = ground_truth.invert()
    m = _joint_mask(prediction, ground_truth)
    pv = prediction.values[m].astype(np.float64)
    gv = ground_truth.values[m].astype(np.float64)
    if prediction.shift is not None and ground_truth.shift is not None:
        # pure scale: both offsets known (ref utils/align.py:163-169,185-188)
        coeffs, _, _, _ = np.linalg.lstsq(
            (pv - prediction.shift)[:, None], gv - ground_truth.shift,
            rcond=None,
        )
        scale = 1.0 / coeffs[0]
        shift = prediction.shift - scale * ground_truth.shift
        return Alignment(
            ground_truth.inverse, float(scale), float(shift),
            ground_truth.scale, ground_truth.shift,
        )
    x = np.stack([pv, np.ones_like(pv)], axis=-1)
    coeffs, _, _, _ = np.linalg.lstsq(x, gv, rcond=None)
    if np.abs(coeffs[0]) <= 0.0:
        return Alignment(ground_truth.inverse, float("inf"), 0.0,
                         ground_truth.scale, ground_truth.shift)
    scale = 1.0 / coeffs[0]
    shift = -coeffs[1] / coeffs[0]
    return Alignment(
        ground_truth.inverse, float(scale), float(shift),
        ground_truth.scale, ground_truth.shift,
    )
