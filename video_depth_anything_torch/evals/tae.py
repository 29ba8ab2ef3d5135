"""Temporal Alignment Error (TAE).

The fork does not implement TAE (SURVEY.md §2.4); this follows the upstream
Video-Depth-Anything paper (arXiv:2501.12375 §4.1): aligned metric depth of
frame t is reprojected into frame t+1 using ground-truth intrinsics and
extrinsics, and compared against the predicted depth there with AbsRel;
averaged bidirectionally over consecutive pairs:

    TAE = 1/(2(T−1)) Σ_t AbsRel(proj(d_t → t+1), d_{t+1})
                        + AbsRel(proj(d_{t+1} → t), d_t)

Convention: ``extrinsics[t]`` is world→camera; the relative transform
cam_t → cam_{t+1} is ``E_{t+1} @ inv(E_t)``.  Reprojection uses forward
z-buffer splatting at nearest pixel; only pixels that land inside the image
with positive depth in both frames contribute.

A copy of the JAX package's ``evals/tae.py``: host numpy, as there.
"""

from __future__ import annotations

import numpy as np


def reproject_depth(
    depth: np.ndarray,
    intrinsics: np.ndarray,
    rel_pose: np.ndarray,
    out_shape=None,
    intrinsics_dst: np.ndarray | None = None,
) -> np.ndarray:
    """Forward-warp ``depth (H, W)`` into the target camera; returns the
    z-buffered target-view depth (0 where nothing lands).  ``intrinsics``
    back-projects the source frame; ``intrinsics_dst`` (default: same)
    projects into the target frame — they differ when K varies per frame."""
    h, w = depth.shape
    out_h, out_w = out_shape or (h, w)
    if intrinsics_dst is None:
        intrinsics_dst = intrinsics
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    fx_d, fy_d = intrinsics_dst[0, 0], intrinsics_dst[1, 1]
    cx_d, cy_d = intrinsics_dst[0, 2], intrinsics_dst[1, 2]

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    z = depth.astype(np.float64)
    valid = z > 0
    x3 = (xx - cx) / fx * z
    y3 = (yy - cy) / fy * z
    pts = np.stack([x3, y3, z, np.ones_like(z)], axis=0).reshape(4, -1)
    tgt = rel_pose.astype(np.float64) @ pts
    zt = tgt[2]
    ok = valid.reshape(-1) & (zt > 1e-6)
    ut = np.round(tgt[0][ok] / zt[ok] * fx_d + cx_d).astype(np.int64)
    vt = np.round(tgt[1][ok] / zt[ok] * fy_d + cy_d).astype(np.int64)
    zt = zt[ok]
    inside = (ut >= 0) & (ut < out_w) & (vt >= 0) & (vt < out_h)
    ut, vt, zt = ut[inside], vt[inside], zt[inside]

    out = np.full((out_h, out_w), np.inf)
    # z-buffer: keep the nearest surface per target pixel
    np.minimum.at(out, (vt, ut), zt)
    out[np.isinf(out)] = 0.0
    return out.astype(np.float32)


def _pair_absrel(proj: np.ndarray, target: np.ndarray, valid: np.ndarray) -> float:
    m = (proj > 0) & (target > 0) & valid
    if not m.any():
        return 0.0
    return float(np.mean(np.abs(proj[m] - target[m]) / target[m]))


def temporal_alignment_error(
    depths: np.ndarray,
    intrinsics: np.ndarray,
    extrinsics: np.ndarray,
    valid: np.ndarray | None = None,
) -> float:
    """``depths (T, H, W)`` aligned metric depth, ``intrinsics (T, 3, 3)``,
    ``extrinsics (T, 4, 4)`` world→camera."""
    t_len = depths.shape[0]
    if t_len < 2:
        return 0.0
    if valid is None:
        valid = np.ones_like(depths, dtype=bool)
    total = 0.0
    for t in range(t_len - 1):
        fwd = extrinsics[t + 1] @ np.linalg.inv(extrinsics[t])
        bwd = extrinsics[t] @ np.linalg.inv(extrinsics[t + 1])
        proj_fwd = reproject_depth(
            depths[t], intrinsics[t], fwd, intrinsics_dst=intrinsics[t + 1]
        )
        proj_bwd = reproject_depth(
            depths[t + 1], intrinsics[t + 1], bwd, intrinsics_dst=intrinsics[t]
        )
        total += _pair_absrel(proj_fwd, depths[t + 1], valid[t + 1])
        total += _pair_absrel(proj_bwd, depths[t], valid[t])
    return total / (2.0 * (t_len - 1))
