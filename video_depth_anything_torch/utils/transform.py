"""Host-side frame preprocessing (cv2): keep-aspect "lower_bound" resize to
the input size with dims rounded to multiples of 14 (INTER_CUBIC on the
[0, 1] image), ImageNet normalization, and the shrink of the input size
for aspect ratios above 1.78.  A copy of the JAX package's cv2 path."""

from __future__ import annotations

from typing import Optional, Tuple

import cv2
import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def constrain_to_multiple_of(x: float, multiple: int, min_val: int = 0) -> int:
    y = int(np.round(x / multiple) * multiple)
    if y < min_val:
        y = int(np.ceil(x / multiple) * multiple)
    return y


def effective_input_size(height: int, width: int, input_size: int = 518) -> int:
    ratio = max(height, width) / min(height, width)
    if ratio > 1.78:
        input_size = int(input_size * 1.777 / ratio)
        input_size = round(input_size / 14) * 14
    return input_size


def model_size_for(height: int, width: int, input_size: int = 518) -> Tuple[int, int]:
    """(model_h, model_w) of the reference "lower_bound" resize."""
    size = effective_input_size(height, width, input_size)
    scale = max(size / height, size / width)
    return (constrain_to_multiple_of(scale * height, 14, min_val=size),
            constrain_to_multiple_of(scale * width, 14, min_val=size))


def bucket_model_size(height: int, width: int, input_size: int = 518,
                      bucket: int = 56) -> Tuple[int, int]:
    """The model resolution snapped to the nearest multiples of ``bucket``
    (itself a multiple of the 14-pixel patch), at least one bucket a side:
    videos of many aspect ratios then share a few window shapes.  Off by
    default (``run --shape_bucket``): it departs from the reference's
    multiple-of-14 sizing by up to ``bucket / 2`` pixels a side."""
    if bucket % 14:
        raise ValueError("bucket must be a multiple of the 14-pixel patch")
    h, w = model_size_for(height, width, input_size)
    return (max(bucket, int(np.round(h / bucket) * bucket)),
            max(bucket, int(np.round(w / bucket) * bucket)))


def preprocess_frames(frames: np.ndarray, input_size: int = 518,
                      target_hw: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """uint8 RGB ``(N, H, W, 3)`` → normalized float32 ``(N, h, w, 3)``."""
    n, h, w, _ = frames.shape
    new_h, new_w = target_hw or model_size_for(h, w, input_size)
    out = np.empty((n, new_h, new_w, 3), dtype=np.float32)
    for i in range(n):
        img = frames[i].astype(np.float32) / 255.0
        img = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_CUBIC)
        out[i] = (img - IMAGENET_MEAN) / IMAGENET_STD
    return out
