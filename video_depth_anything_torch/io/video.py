"""Video decode/encode with cv2: frame reading with max-resolution
downscale and fps striding (the whole clip, or one range of it after a
frame count from the header, for the multi-host pipeline), and depth video
writing with a global min-max
normalization and matplotlib's inferno or Spectral colormap, as the JAX
package writes them (``video_depth_anything_tpu/io/video.py``), from the
port's own tables (``io/colormaps.py``)."""

from __future__ import annotations

import os
from typing import Tuple

import cv2
import numpy as np

from video_depth_anything_torch.io.colormaps import INFERNO, SPECTRAL


def ensure_even(value: int) -> int:
    return value if value % 2 == 0 else value + 1


def read_video_frames(video_path: str, process_length: int = -1, target_fps: float = -1,
                      max_res: int = -1) -> Tuple[np.ndarray, float]:
    """RGB frames ``(N, H, W, 3)`` uint8 and the fps they are sampled at."""
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {video_path}")
    src_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    resize_to = None
    if max_res > 0 and max(height, width) > max_res:
        scale = max_res / max(height, width)
        resize_to = (ensure_even(round(width * scale)), ensure_even(round(height * scale)))
    fps = src_fps if target_fps <= 0 else target_fps
    stride = max(round(src_fps / fps), 1)
    frames = []
    idx = 0
    while True:
        ret, frame = cap.read()
        if not ret:
            break
        if idx % stride == 0:
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            if resize_to is not None:
                frame = cv2.resize(frame, resize_to)
            frames.append(frame)
            if 0 < process_length <= len(frames):
                break
        idx += 1
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {video_path}")
    return np.stack(frames, axis=0), fps


def _open_sampling(video_path: str, target_fps: float):
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {video_path}")
    src_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    fps = src_fps if target_fps <= 0 else target_fps
    stride = max(round(src_fps / fps), 1)
    return cap, fps, stride


def count_video_frames(video_path: str, process_length: int = -1,
                       target_fps: float = -1) -> Tuple[int, float]:
    """(sampled frame count, fps) from the container's frame-count header,
    without decoding: the multi-host pipeline partitions the windows before
    any rank decodes (``parallel/multihost.py``).  Exact for the mp4/avi
    files cv2 writes and ffmpeg-muxed files generally; for VFR streams or
    estimated headers an over-reporting header surfaces late, as a
    ``ValueError`` from ``read_video_frame_range`` on the rank that draws
    the short range.  ``VDA_VALIDATE_FRAME_COUNT=1`` checks the header
    first by counting the stream with ``grab()`` (one decode pass, no
    colour conversion), so a bad container fails on every rank before any
    compute."""
    cap, fps, stride = _open_sampling(video_path, target_fps)
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    if os.environ.get("VDA_VALIDATE_FRAME_COUNT", "0") == "1":
        counted = 0
        while cap.grab():
            counted += 1
        if counted != total:
            cap.release()
            raise ValueError(
                f"container header reports {total} frames but the stream "
                f"holds {counted}: {video_path} (VFR/estimated header; "
                "multi-host spans would be mispartitioned)")
    cap.release()
    if total <= 0:
        raise ValueError(f"container reports no frame count: {video_path}")
    n = (total + stride - 1) // stride
    if process_length > 0:
        n = min(n, process_length)
    return n, fps


def read_video_frame_range(video_path: str, start: int, stop: int, target_fps: float = -1,
                           max_res: int = -1) -> np.ndarray:
    """Sampled frames ``[start, stop)`` only (each multi-host rank decodes
    its span): ``read_video_frames(...)[0][start:stop]`` bit for bit.
    Seeks to the range where the container's position reads back as asked,
    else skips from the head with ``grab()`` (no colour conversion of the
    skipped frames); ``VDA_SEEK_MODE=grab`` forces the frame-exact skip for
    containers whose seeks are only keyframe-approximate."""
    cap, _, stride = _open_sampling(video_path, target_fps)
    height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    resize_to = None
    if max_res > 0 and max(height, width) > max_res:
        scale = max_res / max(height, width)
        resize_to = (ensure_even(round(width * scale)), ensure_even(round(height * scale)))
    raw_start = start * stride
    pos = 0
    if raw_start:
        if (os.environ.get("VDA_SEEK_MODE", "auto") != "grab"
                and cap.set(cv2.CAP_PROP_POS_FRAMES, raw_start)
                and int(cap.get(cv2.CAP_PROP_POS_FRAMES)) == raw_start):
            pos = raw_start
        else:
            cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
            while pos < raw_start and cap.grab():
                pos += 1
    frames = []
    while len(frames) < stop - start:
        ret, frame = cap.read()
        if not ret:
            break
        if (pos - raw_start) % stride == 0:
            frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            if resize_to is not None:
                frame = cv2.resize(frame, resize_to)
            frames.append(frame)
        pos += 1
    cap.release()
    if len(frames) < stop - start:
        raise ValueError(f"decoded {len(frames)} frames for range [{start},{stop}) of {video_path}")
    return np.stack(frames, axis=0)


def colorize_depth(depths: np.ndarray, grayscale: bool = False,
                   spectral: bool = False) -> np.ndarray:
    """Depth stack → uint8 RGB frames: global min-max to 0..255, then the
    inferno (or Spectral) table, or gray."""
    d_min, d_max = float(depths.min()), float(depths.max())
    norm = ((depths - d_min) / ((d_max - d_min) or 1.0) * 255.0).astype(np.uint8)
    if grayscale:
        return np.repeat(norm[..., None], 3, axis=-1)
    return (SPECTRAL if spectral else INFERNO)[norm]


def save_video(frames: np.ndarray, output_path: str, fps: float = 10, is_depths: bool = False,
               grayscale: bool = False, spectral: bool = False) -> None:
    """Write RGB uint8 frames, or depth frames colorized, to an mp4 (mp4v)."""
    if is_depths:
        frames = colorize_depth(frames, grayscale=grayscale, spectral=spectral)
    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(output_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"cannot open video writer for {output_path}")
    for frame in frames:
        writer.write(cv2.cvtColor(np.ascontiguousarray(frame), cv2.COLOR_RGB2BGR))
    writer.release()


def write_tiff_stack(path: str, frames: np.ndarray) -> None:
    """A float32 ``(N, H, W)`` stack as a multi-page TIFF of mode-"F" pages,
    which round-trip float32 bit for bit (``run --save_tiff``).  Refuses an
    empty stack (a streaming run shorter than its window emits none).  PIL
    is imported here: the port needs it for this output only."""
    from PIL import Image

    frames = np.ascontiguousarray(frames, dtype=np.float32)
    if frames.shape[0] == 0:
        raise ValueError("write_tiff_stack: empty depth stack (0 frames)")
    pages = [Image.fromarray(f) for f in frames]  # float32 → mode "F"
    pages[0].save(path, save_all=True, append_images=pages[1:])


def read_tiff_stack(path: str) -> np.ndarray:
    """A multi-page float TIFF back as float32 ``(N, H, W)``."""
    from PIL import Image

    with Image.open(path) as im:
        pages = []
        for i in range(im.n_frames):
            im.seek(i)
            pages.append(np.array(im, dtype=np.float32))
        return np.stack(pages)
