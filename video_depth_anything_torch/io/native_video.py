"""ctypes binding of the native video decoder (``native/decode.cpp``), a copy
of the JAX package's ``io/native_video.py`` over the port's own build
(``io/native_build.py``).

libav decode → swscale RGB24 with the frame stride applied inside the
decode loop, read 64 frames a call.  ``max_res`` is applied afterwards with
``cv2.resize`` in Python, so that the pixels are those of the cv2 path of
``io/video.read_video_frames``.  ``None`` when the library cannot be built
or loaded or the container cannot be opened: the caller then decodes with
cv2.

The library reproduces cv2's pixels only for frames whose width is a
multiple of 16 (``ALIGNED_WIDTH``).  ``decode.cpp``'s ``to_rgb`` hands
swscale rows of ``3 * width`` bytes; at other widths swscale's vector
path writes wrong values into the last ``width % 16`` columns of every
row (the DAVIS width, 854: columns 848-853), and at widths of 8 mod 16 it
also writes past the end of the buffer, which corrupts the heap and kills
the process.  The JAX package's binding of the same source has the same
fault.  So this binding decodes natively only at widths that are
multiples of 16 and returns ``None`` (cv2 then decodes) at any other.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from video_depth_anything_torch.io import native_build

_CHUNK = 64  # frames a read call
ALIGNED_WIDTH = 16  # the widths at which the library's pixels are cv2's
_typed = False


def _load() -> Optional[ctypes.CDLL]:
    global _typed
    lib = native_build.load("decode")
    if lib is not None and not _typed:
        lib.vda_video_open.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                                       ctypes.POINTER(ctypes.c_int),
                                       ctypes.POINTER(ctypes.c_double)]
        lib.vda_video_open.restype = ctypes.c_void_p
        lib.vda_video_read.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
                                       ctypes.c_long, ctypes.c_int]
        lib.vda_video_read.restype = ctypes.c_long
        lib.vda_video_close.argtypes = [ctypes.c_void_p]
        lib.vda_video_close.restype = None
        _typed = True
    return lib


def available() -> bool:
    return _load() is not None


def read_video_frames_native(video_path: str, process_length: int = -1, target_fps: float = -1,
                             max_res: int = -1) -> Optional[Tuple[np.ndarray, float]]:
    """The contract of ``io.video.read_video_frames``; ``None`` → the caller
    falls back to cv2."""
    lib = _load()
    if lib is None:
        return None
    w, h, fps = ctypes.c_int(), ctypes.c_int(), ctypes.c_double()
    handle = lib.vda_video_open(video_path.encode(), ctypes.byref(w), ctypes.byref(h),
                                ctypes.byref(fps))
    if not handle:
        return None
    try:
        if w.value % ALIGNED_WIDTH:
            return None
        src_fps = fps.value or 30.0
        out_fps = src_fps if target_fps <= 0 else target_fps
        stride = max(round(src_fps / out_fps), 1)
        chunks, total = [], 0
        limit = process_length if process_length > 0 else None
        while True:
            want = _CHUNK if limit is None else min(_CHUNK, limit - total)
            if want <= 0:
                break
            buf = np.empty((want, h.value, w.value, 3), dtype=np.uint8)
            got = lib.vda_video_read(handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                     want, stride)
            if got < 0:
                return None
            if got:
                chunks.append(buf[:got])
                total += int(got)
            if got < want:
                break
        if not chunks:
            return None
        frames = chunks[0] if len(chunks) == 1 else np.concatenate(chunks, axis=0)
        if max_res > 0 and max(frames.shape[1], frames.shape[2]) > max_res:
            import cv2

            from video_depth_anything_torch.io.video import ensure_even

            scale = max_res / max(frames.shape[1], frames.shape[2])
            rw = ensure_even(round(frames.shape[2] * scale))
            rh = ensure_even(round(frames.shape[1] * scale))
            frames = np.stack([cv2.resize(f, (rw, rh)) for f in frames], axis=0)
        return frames, out_fps
    finally:
        lib.vda_video_close(handle)
