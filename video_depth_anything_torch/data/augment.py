"""Training-clip augmentation (a copy of the JAX package's numpy
``data/augment.py``; the same seed gives the same arrays).

Design rules:
* one draw per CLIP — every frame of a clip gets the same transform, so
  the temporal-gradient loss still sees consistent motion;
* geometric transforms (flip, scaled crop) move frames, depth, and
  validity mask with the SAME index arithmetic, and rewrite the pinhole
  intrinsics accordingly (OpenCV convention: pixel centers at integer
  coordinates, so a horizontal flip maps ``x → W−1−x``);
* photometric transforms (brightness/contrast/per-channel color gain)
  touch the FRAMES ONLY — depth, mask, and intrinsics are invariant;
* disparity targets are derived AFTER augmentation (``clips.py``
  computes ``1/depth`` from the already-augmented depth), so flip
  consistency of disparity is by construction.

All host-side numpy/cv2 work (runs in the ``Prefetcher`` thread).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Per-clip augmentation strengths; defaults follow the common
    monocular-depth training recipe (MiDaS-style geometric + light
    photometric jitter)."""

    hflip_prob: float = 0.5
    # scaled crop: side scale drawn from U[crop_min_scale, 1]; 1.0 disables
    crop_min_scale: float = 0.6
    # photometric (frames only): multiplicative jitters, 0 disables each
    brightness: float = 0.2
    contrast: float = 0.2
    color: float = 0.1


def hflip_intrinsics(K: np.ndarray, width: int) -> np.ndarray:
    """Principal point under ``x → W−1−x`` (fx/fy unchanged)."""
    K = np.array(K, np.float64, copy=True)
    K[..., 0, 2] = (width - 1) - K[..., 0, 2]
    return K


def crop_intrinsics(K: np.ndarray, x0: int, y0: int) -> np.ndarray:
    """Principal point under a crop with top-left corner (x0, y0)."""
    K = np.array(K, np.float64, copy=True)
    K[..., 0, 2] -= x0
    K[..., 1, 2] -= y0
    return K


def augment_clip(
    rgb: np.ndarray,
    depth: np.ndarray,
    valid: np.ndarray,
    rng: np.random.RandomState,
    cfg: AugmentConfig = AugmentConfig(),
    intrinsics: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Augment one clip.

    ``rgb (T, H, W, 3) uint8``, ``depth (T, H, W)``, ``valid (T, H, W)``,
    optional ``intrinsics (T, 3, 3)`` or ``(3, 3)``.  Returns the four in
    the same formats (intrinsics ``None`` in → ``None`` out).
    """
    h, w = rgb.shape[1:3]

    # -- scaled crop (geometric) --------------------------------------------
    if cfg.crop_min_scale < 1.0:
        s = float(rng.uniform(cfg.crop_min_scale, 1.0))
        ch = max(2, int(round(h * s)))
        cw = max(2, int(round(w * s)))
        y0 = int(rng.randint(0, h - ch + 1))
        x0 = int(rng.randint(0, w - cw + 1))
        rgb = rgb[:, y0 : y0 + ch, x0 : x0 + cw]
        depth = depth[:, y0 : y0 + ch, x0 : x0 + cw]
        valid = valid[:, y0 : y0 + ch, x0 : x0 + cw]
        if intrinsics is not None:
            intrinsics = crop_intrinsics(intrinsics, x0, y0)
        h, w = ch, cw

    # -- horizontal flip (geometric) ----------------------------------------
    if cfg.hflip_prob > 0 and rng.rand() < cfg.hflip_prob:
        rgb = rgb[:, :, ::-1]
        depth = depth[:, :, ::-1]
        valid = valid[:, :, ::-1]
        if intrinsics is not None:
            intrinsics = hflip_intrinsics(intrinsics, w)

    # -- photometric (frames only) ------------------------------------------
    if cfg.brightness or cfg.contrast or cfg.color:
        x = rgb.astype(np.float32)
        if cfg.brightness:
            x *= float(rng.uniform(1 - cfg.brightness, 1 + cfg.brightness))
        if cfg.contrast:
            c = float(rng.uniform(1 - cfg.contrast, 1 + cfg.contrast))
            x = (x - x.mean()) * c + x.mean()
        if cfg.color:
            gains = rng.uniform(1 - cfg.color, 1 + cfg.color, size=3)
            x *= gains.astype(np.float32)
        rgb = np.clip(x, 0, 255).astype(np.uint8)

    return (
        np.ascontiguousarray(rgb),
        np.ascontiguousarray(depth),
        np.ascontiguousarray(valid),
        intrinsics,
    )
