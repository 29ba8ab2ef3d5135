"""Resizes with PyTorch's interpolation semantics.

* ``bilinear_resize``: ``align_corners=True`` bilinear over the H and W
  axes of an NHWC tensor, the resize of every feature-map upsample in the
  DPT head and of the depth map.  ``F.interpolate`` computes it (in fp32
  on the card, whatever the storage type).
* ``bicubic_pos_embed_resize``: the DINOv2 positional-embedding resize
  (``align_corners=False`` with an explicit scale factor, Keys A = -0.75),
  applied as two host-built weight matrices in fp32.  The 1-D matrices
  replicate torch's fp32 source-coordinate arithmetic.
* ``bilinear_resize_np``: the host (numpy) twin of ``bilinear_resize`` for
  the pipeline's ``host_upsample`` mode.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _cubic_weight_matrix(in_size: int, out_size: int, scale: float) -> np.ndarray:
    """(out, in) bicubic matrix; source ``(dst + 0.5) / scale - 0.5`` in fp32,
    4 taps with edge clamping."""
    w = np.zeros((out_size, in_size), dtype=np.float64)
    inv = np.float32(1.0) / np.float32(scale)
    a = -0.75
    for dst in range(out_size):
        src = float((np.float32(dst) + np.float32(0.5)) * inv - np.float32(0.5))
        base = int(np.floor(src))
        frac = src - base
        for t, x in enumerate((frac + 1.0, frac, 1.0 - frac, 2.0 - frac)):
            x = abs(x)
            if x <= 1.0:
                c = ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
            elif x < 2.0:
                c = (((x - 5.0) * x + 8.0) * x - 4.0) * a
            else:
                c = 0.0
            w[dst, min(max(base - 1 + t, 0), in_size - 1)] += c
    return w.astype(np.float32)


# F.interpolate's channels-last CUDA kernel takes outputs of fewer than
# 2^31 elements (32-bit indexing): vitb's window batch of 4 resizes 128
# frames of 296x528x128 in refinenet1 at 518x924 (2.6e9) and of 518x518x64
# in the output head at 518x518 (2.2e9).
_MAX_ELEMENTS = 2**31 - 1


def bilinear_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear ``align_corners=True`` resize of ``(N, H, W, C)``; a batch
    whose output would pass ``_MAX_ELEMENTS`` is resized in chunks of
    frames."""
    h, w = x.shape[-3], x.shape[-2]
    if (h, w) == (out_h, out_w):
        return x
    per_frame = out_h * out_w * x.shape[-1]
    if x.shape[0] > 1 and x.shape[0] * per_frame > _MAX_ELEMENTS:
        n = max(1, _MAX_ELEMENTS // per_frame)
        return torch.cat([bilinear_resize(c, out_h, out_w) for c in x.split(n)])
    y = F.interpolate(
        x.permute(0, 3, 1, 2), size=(out_h, out_w), mode="bilinear",
        align_corners=True,
    )
    return y.permute(0, 2, 3, 1)


def bicubic_pos_embed_resize(
    pos: torch.Tensor, out_h: int, out_w: int, scale_h: float, scale_w: float
) -> torch.Tensor:
    """Bicubic resize of an ``(H, W, C)`` grid with torch scale-factor
    semantics, in fp32; returns the input dtype."""
    h, w = pos.shape[0], pos.shape[1]
    wh = torch.from_numpy(_cubic_weight_matrix(h, out_h, float(scale_h))).to(pos.device)
    ww = torch.from_numpy(_cubic_weight_matrix(w, out_w, float(scale_w))).to(pos.device)
    xf = pos.float()
    xf = torch.einsum("oh,hwc->owc", wh, xf)
    xf = torch.einsum("ow,hwc->hoc", ww, xf)
    return xf.to(pos.dtype)


@functools.lru_cache(maxsize=None)
def _linear_taps(in_size: int, out_size: int):
    """Per-output (lo, hi, w_lo, w_hi) align_corners taps in fp32."""
    lo_a = np.zeros(out_size, np.int64)
    hi_a = np.zeros(out_size, np.int64)
    wlo = np.ones(out_size, np.float32)
    whi = np.zeros(out_size, np.float32)
    if out_size == 1:
        return lo_a, hi_a, wlo, whi
    scale = np.float32(in_size - 1) / np.float32(out_size - 1)
    for dst in range(out_size):
        src = np.float32(dst) * scale
        lo = min(int(np.floor(src)), in_size - 1)
        hi = min(lo + 1, in_size - 1)
        frac = float(src) - lo
        lo_a[dst], hi_a[dst] = lo, hi
        if lo == hi:
            wlo[dst], whi[dst] = 1.0, 0.0
        else:
            wlo[dst] = np.float64(1.0) - frac
            whi[dst] = frac
    return lo_a, hi_a, wlo, whi


def bilinear_resize_np(x: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Host twin of ``bilinear_resize`` for ``(..., H, W)`` arrays (fp32,
    H pass then W pass)."""
    h, w = x.shape[-2], x.shape[-1]
    xf = np.asarray(x, np.float32)
    if (h, w) == (out_h, out_w):
        return xf
    if h != out_h:
        lo, hi, wl, wh = _linear_taps(h, out_h)
        xf = xf[..., lo, :] * wl[:, None] + xf[..., hi, :] * wh[:, None]
    if w != out_w:
        lo, hi, wl, wh = _linear_taps(w, out_w)
        xf = xf[..., lo] * wl + xf[..., hi] * wh
    return xf
