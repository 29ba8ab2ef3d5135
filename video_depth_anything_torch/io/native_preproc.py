"""ctypes binding of the native preprocessing library (``native/preproc.cpp``),
a copy of the JAX package's ``io/native_preproc.py`` over the port's own
build (``io/native_build.py``: compiled from the repo's source into
``_build/``, never the library committed under ``native/``).

``preprocess_frames_native`` is the fused uint8 → [0, 1] → bicubic resize
→ ImageNet normalisation of ``utils/transform.preprocess_frames`` (cv2's
INTER_CUBIC coordinates and taps; within 2e-3 of it, the sums' order
differs), OpenMP over frames; ``gather_windows_native`` copies the
preprocessed frames of each window slot (``pre[indices]``) in threads.
Both return ``None`` when the library cannot be built or loaded.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from video_depth_anything_torch.io import native_build
from video_depth_anything_torch.utils.transform import IMAGENET_MEAN, IMAGENET_STD, model_size_for

_f32p = ctypes.POINTER(ctypes.c_float)
_typed = False


def _load() -> Optional[ctypes.CDLL]:
    global _typed
    lib = native_build.load("preproc")
    if lib is not None and not _typed:
        lib.vda_preprocess_frames.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _f32p, ctypes.c_int, ctypes.c_int, _f32p, _f32p]
        lib.vda_preprocess_frames.restype = None
        lib.vda_gather_windows.argtypes = [
            _f32p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
            ctypes.c_int64, _f32p]
        lib.vda_gather_windows.restype = None
        _typed = True
    return lib


def available() -> bool:
    return _load() is not None


def preprocess_frames_native(frames: np.ndarray, input_size: int = 518,
                             target_hw=None) -> Optional[np.ndarray]:
    """uint8 RGB ``(N, H, W, 3)`` → normalised float32 ``(N, h, w, 3)``;
    ``None`` when the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    n, h, w, _ = frames.shape
    dh, dw = target_hw or model_size_for(h, w, input_size)
    out = np.empty((n, dh, dw, 3), dtype=np.float32)
    mean = np.ascontiguousarray(IMAGENET_MEAN, dtype=np.float32)
    std = np.ascontiguousarray(IMAGENET_STD, dtype=np.float32)
    lib.vda_preprocess_frames(frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, h, w,
                              out.ctypes.data_as(_f32p), dh, dw, mean.ctypes.data_as(_f32p),
                              std.ctypes.data_as(_f32p))
    return out


def gather_windows_native(pre: np.ndarray, indices: np.ndarray) -> Optional[np.ndarray]:
    """``pre (F, h, w, 3)`` fp32 and ``indices (W, T)`` → ``(W, T, h, w, 3)``,
    ``pre[indices]`` bit for bit."""
    lib = _load()
    if lib is None:
        return None
    pre = np.ascontiguousarray(pre, dtype=np.float32)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    n_win, win_len = indices.shape
    frame_elems = int(np.prod(pre.shape[1:]))
    out = np.empty((n_win, win_len) + pre.shape[1:], dtype=np.float32)
    lib.vda_gather_windows(pre.ctypes.data_as(_f32p),
                           indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                           n_win, win_len, frame_elems, out.ctypes.data_as(_f32p))
    return out
