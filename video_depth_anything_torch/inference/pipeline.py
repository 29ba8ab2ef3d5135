"""Sliding-window long-video inference (the JAX package's
``inference/pipeline.py``).

Window inputs are pure functions of the raw frames: the keyframe splice of
the reference copies *inputs*, so ``window_frame_indices`` resolves every
window slot's global frame up front and all windows are independent model
calls, batched ``window_batch`` at a time.  Stitching is a short
sequential host pass of per-window scale/shift fits and the 8-frame
cross-fade (``stitch_windows``).  Depth reaches the host in fp32.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from video_depth_anything_torch.config import INFER_LEN, INTERP_LEN, KEYFRAMES, OVERLAP
from video_depth_anything_torch.ops.resize import bilinear_resize, bilinear_resize_np
from video_depth_anything_torch.ops.scale_shift import (
    compute_scale_and_shift,
    interpolation_weights,
)
from video_depth_anything_torch.utils.transform import model_size_for, preprocess_frames


def num_windows(n_frames: int) -> int:
    step = INFER_LEN - OVERLAP
    return max(1, -(-n_frames // step))


def padded_length(n_frames: int) -> int:
    """Frames after tail-padding with copies of the last frame."""
    step = INFER_LEN - OVERLAP
    return n_frames + (step - (n_frames % step)) % step + (INFER_LEN - step)


def window_frame_indices(n_frames: int) -> np.ndarray:
    """(n_windows, INFER_LEN) global frame indices of each window's slots
    after keyframe splicing."""
    step = INFER_LEN - OVERLAP
    n_win = num_windows(n_frames)
    out = np.empty((n_win, INFER_LEN), dtype=np.int64)
    out[0] = np.arange(INFER_LEN)
    kf = np.asarray(KEYFRAMES)
    for w in range(1, n_win):
        out[w, :OVERLAP] = out[w - 1][kf]
        out[w, OVERLAP:] = w * step + np.arange(OVERLAP, INFER_LEN)
    return out


def stitch_windows(window_depths: List[np.ndarray], org_len: int) -> np.ndarray:
    """Scale/shift-align consecutive windows and cross-fade the overlaps."""
    align_len = OVERLAP - INTERP_LEN
    kf_ids = list(KEYFRAMES[:align_len])
    post_w = interpolation_weights(INTERP_LEN)
    aligned: List[np.ndarray] = []
    ref_align: List[np.ndarray] = []
    for w, d in enumerate(window_depths):
        if w == 0:
            aligned.extend(d[i] for i in range(INFER_LEN))
            ref_align = [d[k] for k in kf_ids]
            continue
        curr = np.concatenate([d[i] for i in range(align_len)])
        s, t = compute_scale_and_shift(curr, np.concatenate(ref_align))
        pre = aligned[-INTERP_LEN:]
        post = [np.maximum(d[i] * s + t, 0.0) for i in range(align_len, OVERLAP)]
        aligned[-INTERP_LEN:] = [
            pre[i] * (1.0 - post_w[i]) + post[i] * post_w[i] for i in range(INTERP_LEN)
        ]
        for i in range(OVERLAP, INFER_LEN):
            aligned.append(np.maximum(d[i] * s + t, 0.0))
        # ref frame 0 stays the first window's keyframe for the whole clip
        ref_align = [ref_align[0]] + [np.maximum(d[k] * s + t, 0.0) for k in kf_ids[1:]]
    return np.stack(aligned[:org_len], axis=0)


class VideoDepthPipeline:
    """Long-video inference around a ``VDAModel``.

    ``window_batch``: windows per model call (they are independent);
    ``None`` picks 4 for the vits/vitb heads and 1 for vitl and larger.
    ``host_upsample``: the device returns model-resolution depth and the
    upsample to the source resolution runs on the host (same fp32 taps)."""

    def __init__(self, model, input_size: int = 518, window_batch: Optional[int] = None,
                 host_upsample: bool = False):
        self.model = model
        self.input_size = input_size
        if window_batch is None:
            window_batch = 4 if model.cfg.features <= 128 else 1
        self.window_batch = max(1, int(window_batch))
        self.host_upsample = bool(host_upsample)

    def compute_window_depths(self, pre: np.ndarray, idx: np.ndarray, fh: int, fw: int,
                              skip_tmp_block: bool = False) -> List[np.ndarray]:
        """Window forwards for ``idx (n, INFER_LEN)`` over the preprocessed
        frames; the last batch repeats the final window and drops it."""
        n_win, wb = idx.shape[0], self.window_batch
        if n_win % wb:
            idx = np.concatenate([idx, np.repeat(idx[-1:], (-n_win) % wb, axis=0)], axis=0)
        out: List[np.ndarray] = []
        for s in range(0, len(idx), wb):
            depth = self.model.infer_window(pre[idx[s : s + wb]], skip_tmp_block=skip_tmp_block)
            b, t, h, w = depth.shape
            depth = depth.float()
            if not self.host_upsample:
                depth = bilinear_resize(depth.reshape(b * t, h, w, 1), fh, fw).reshape(b, t, fh, fw)
            depth = depth.cpu().numpy()
            if self.host_upsample:
                depth = bilinear_resize_np(depth, fh, fw)
            out.extend(depth)
        return out[:n_win]

    def infer_video_depth(self, frames: np.ndarray, target_fps: float = -1,
                          skip_tmp_block: bool = False) -> Tuple[np.ndarray, float]:
        """uint8 RGB ``(N, H, W, 3)`` → (depth ``(N, H, W)`` fp32, fps)."""
        org_len, fh, fw = frames.shape[:3]
        pad_len = padded_length(org_len)
        mh, mw = model_size_for(fh, fw, self.input_size)
        pre = np.empty((pad_len, mh, mw, 3), np.float32)
        pre[:org_len] = preprocess_frames(frames, self.input_size, (mh, mw))
        pre[org_len:] = pre[org_len - 1]
        depths = self.compute_window_depths(
            pre, window_frame_indices(org_len), fh, fw, skip_tmp_block=skip_tmp_block)
        return stitch_windows(depths, org_len), target_fps
