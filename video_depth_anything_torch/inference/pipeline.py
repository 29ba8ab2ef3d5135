"""Sliding-window long-video inference (the JAX package's
``inference/pipeline.py``).

Window inputs are pure functions of the raw frames: the keyframe splice of
the reference copies *inputs*, so ``window_frame_indices`` resolves every
window slot's global frame up front and all windows are independent model
calls, batched ``window_batch`` at a time.  Stitching is a short
sequential host pass of per-window scale/shift fits and the 8-frame
cross-fade (``stitch_windows``), in fp32 on the host whatever the transfer
dtype.  Preprocessing runs in a producer thread, and each window batch's
copy to the host overlaps the next batch's forward, as in the JAX pipeline.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

import numpy as np

from video_depth_anything_torch.config import INFER_LEN, INTERP_LEN, KEYFRAMES, OVERLAP
from video_depth_anything_torch.ops.resize import bilinear_resize, bilinear_resize_np
from video_depth_anything_torch.ops.scale_shift import (
    compute_scale_and_shift,
    interpolation_weights,
)
from video_depth_anything_torch.utils.device import (
    HostTransfer,
    env_switch,
    resolve_transfer_dtype,
    start_host_transfer,
    transfer_cast,
)
from video_depth_anything_torch.utils.stats import Progress
from video_depth_anything_torch.utils.transform import (
    bucket_model_size,
    model_size_for,
    preprocess_frames,
)


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


# The lagged copy keeps one more (wb, T, h, w) depth batch alive on the card;
# from this many bytes a batch it is off, so that the peak stays that of the
# synchronous path (the JAX pipeline's overlap_d2h).
D2H_OVERLAP_BYTES = 512 * 2**20


class VideoDepthPipeline:
    """Long-video inference around a ``VDAModel``.

    ``shape_bucket``: snap the model resolution to multiples of this many
    pixels (``bucket_model_size``; a multiple of 14), so that videos of
    many aspect ratios share a few window shapes; ``None`` keeps the
    reference's sizing.  ``window_batch``: windows per model call (they are
    independent); ``None`` picks 4 for the vits/vitb heads and 1 for vitl
    and larger.  ``host_upsample``: the device returns model-resolution
    depth and the upsample to the source resolution runs on the host (same
    fp32 taps); ``None`` reads ``VDA_HOST_UPSAMPLE``.  ``transfer_dtype``
    (``fp32``/``fp16``): each window's depth is cast to it after the device
    resize and before its copy to the host, where the stitch runs in fp32;
    ``None`` reads ``VDA_TRANSFER_DTYPE``."""

    def __init__(self, model, input_size: int = 518, shape_bucket: Optional[int] = None,
                 window_batch: Optional[int] = None, host_upsample: Optional[bool] = None,
                 transfer_dtype: Optional[str] = None):
        self.model = model
        self.input_size = input_size
        self.shape_bucket = shape_bucket
        if window_batch is None:
            window_batch = 4 if model.cfg.features <= 128 else 1
        self.window_batch = max(1, int(window_batch))
        self.host_upsample = env_switch(host_upsample, "VDA_HOST_UPSAMPLE", default=False)
        self.transfer_dtype = resolve_transfer_dtype(transfer_dtype)

    def _target_hw(self, fh: int, fw: int) -> Optional[Tuple[int, int]]:
        if self.shape_bucket is None:
            return None
        return bucket_model_size(fh, fw, self.input_size, self.shape_bucket)

    def _preprocess_pipelined(self, frames: np.ndarray, pad_len: int,
                              target_hw: Optional[Tuple[int, int]]):
        """``(pre, wait_until, thread)``: a producer thread fills ``pre``
        chunk by chunk (``INFER_LEN - OVERLAP`` frames; cv2 releases the
        interpreter lock), then the tail padding; ``wait_until(n)`` blocks
        until the first ``n`` padded frames are ready and raises the
        worker's exception again in the caller.  The worker does numpy and
        cv2 work only: every torch call stays on the calling thread."""
        org_len, fh, fw = frames.shape[:3]
        mh, mw = target_hw or model_size_for(fh, fw, self.input_size)
        pre = np.empty((pad_len, mh, mw, 3), np.float32)
        chunk = INFER_LEN - OVERLAP
        state = {"ready": 0, "err": None}
        cond = threading.Condition()

        def worker():
            try:
                for a in range(0, org_len, chunk):
                    b = min(org_len, a + chunk)
                    pre[a:b] = preprocess_frames(frames[a:b], self.input_size, (mh, mw))
                    with cond:
                        state["ready"] = b
                        cond.notify_all()
                pre[org_len:] = pre[org_len - 1]
                with cond:
                    state["ready"] = pad_len
                    cond.notify_all()
            except BaseException as e:  # noqa: BLE001 - raised again by wait_until
                with cond:
                    state["err"] = e
                    cond.notify_all()

        thread = threading.Thread(target=worker, name="vda-preprocess", daemon=True)
        thread.start()

        def wait_until(n: int) -> None:
            with cond:
                while state["ready"] < n and state["err"] is None:
                    cond.wait()
                if state["err"] is not None:
                    raise state["err"]

        return pre, wait_until, thread

    def _gather(self, pre: np.ndarray, chunk: np.ndarray) -> np.ndarray:
        """The input of one window batch, ``pre[chunk]``."""
        return pre[chunk]

    def _window_forward(self, frames: np.ndarray, skip_tmp_block: bool):
        """The model-resolution depth of a batch of windows on the device
        (the pipeline-parallel pipeline stages it over ranks)."""
        return self.model.infer_window(frames, skip_tmp_block=skip_tmp_block)

    def compute_window_depths(self, pre: np.ndarray, idx: np.ndarray, fh: int, fw: int,
                              skip_tmp_block: bool = False, progress: bool = False,
                              wait_until=None, desc: str = "windows") -> List[np.ndarray]:
        """Window forwards for ``idx (n, INFER_LEN)`` over the preprocessed
        frames, as fp32 host maps at ``(fh, fw)``; the last batch repeats
        the final window and drops it.  Each batch's copy to the host starts
        as soon as it is enqueued and is read one batch later, so that it
        overlaps the next batch's forward, unless a batch's depth holds
        ``D2H_OVERLAP_BYTES`` or more.  ``wait_until(n)`` (from
        ``_preprocess_pipelined``) is called before a batch reads frames up
        to ``n``."""
        n_win, wb = idx.shape[0], self.window_batch
        if n_win % wb:
            idx = np.concatenate([idx, np.repeat(idx[-1:], (-n_win) % wb, axis=0)], axis=0)
        dev_h, dev_w = (pre.shape[1], pre.shape[2]) if self.host_upsample else (fh, fw)
        overlap_d2h = wb * INFER_LEN * dev_h * dev_w * 4 < D2H_OVERLAP_BYTES
        bar = Progress(-(-len(idx) // wb), f"{desc} (x{wb})", enabled=progress)
        out: List[np.ndarray] = []

        def drain(transfer: HostTransfer) -> None:
            d = transfer.numpy()  # fp32 on the host whatever the transfer dtype
            out.extend(bilinear_resize_np(d, fh, fw) if self.host_upsample else d)
            bar.update()

        pending = None
        for s in range(0, len(idx), wb):
            chunk = idx[s:s + wb]
            if wait_until is not None:
                wait_until(int(chunk.max()) + 1)
            depth = self._window_forward(self._gather(pre, chunk), skip_tmp_block)
            b, t, h, w = depth.shape
            depth = depth.float()
            if not self.host_upsample:
                depth = bilinear_resize(depth.reshape(b * t, h, w, 1), fh, fw).reshape(b, t, fh, fw)
            transfer = start_host_transfer(transfer_cast(depth, self.transfer_dtype))
            if not overlap_d2h:
                drain(transfer)
                continue
            if pending is not None:
                drain(pending)
            pending = transfer
        if pending is not None:
            drain(pending)
        bar.close()
        return out[:n_win]

    def infer_video_depth(self, frames: np.ndarray, target_fps: float = -1,
                          skip_tmp_block: bool = False,
                          progress: bool = False) -> Tuple[np.ndarray, float]:
        """uint8 RGB ``(N, H, W, 3)`` → (depth ``(N, H, W)`` fp32, fps);
        preprocessing runs in a producer thread beside the forwards."""
        org_len, fh, fw = frames.shape[:3]
        pre, wait_until, thread = self._preprocess_pipelined(
            frames, padded_length(org_len), self._target_hw(fh, fw))
        depths = self.compute_window_depths(
            pre, window_frame_indices(org_len), fh, fw, skip_tmp_block=skip_tmp_block,
            progress=progress, wait_until=wait_until)
        thread.join()
        return stitch_windows(depths, org_len), target_fps
