"""Data-parallel and multi-host sliding-window inference, one mechanism (the
JAX package's ``parallel/data_parallel.py`` and the pipeline of its
``parallel/multihost.py``).

Every window is an independent model call once ``window_frame_indices``
has resolved the keyframe splice, so the windows split over the grid's
``data`` groups by ``host_window_spans``: each group decodes
(``decode_range``) and preprocesses only the frames its windows read, pads
the global tail as the single process does, runs its windows through the
base pipeline's window loop (producer-thread preprocessing, lagged copies,
``host_upsample`` and the transfer dtype kept), and the groups exchange
their depths (``exchange_windows``).  Every rank then stitches and returns
the whole result, which is the single-process one: each window's forward
is the single process's.  With ``model_parallel > 1`` the encoder of each
group is split over its ranks (``mesh.shard_module``) before the first
window.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from video_depth_anything_torch.config import INFER_LEN
from video_depth_anything_torch.inference.pipeline import (
    VideoDepthPipeline,
    stitch_windows,
    window_frame_indices,
)
from video_depth_anything_torch.parallel import comm
from video_depth_anything_torch.parallel.mesh import Grid, create_grid, shard_module
from video_depth_anything_torch.parallel.multihost import HostWindowSpan, host_window_spans


def exchange_windows(local: List[np.ndarray], spans: Sequence[HostWindowSpan], shape: tuple,
                     group: comm.Group) -> List[np.ndarray]:
    """Every data group's window depths, in window order, on every rank.
    Round r gathers each group's r-th window (zeros from a group that has
    fewer), so that a collective holds one window a group, never the
    video: at 1080p a window is 265 MB, a long video hundreds of them."""
    counts = [s.window_stop - s.window_start for s in spans]
    windows: List[List[np.ndarray]] = [[] for _ in spans]
    for r in range(max(counts)):
        mine = local[r] if r < len(local) else np.zeros(shape, np.float32)
        pieces = comm.all_gather(torch.from_numpy(np.ascontiguousarray(mine, np.float32)), group)
        for h, piece in enumerate(pieces):
            if r < counts[h]:
                windows[h].append(piece.numpy())
    return [w for group_windows in windows for w in group_windows]


class DataParallelVideoDepthPipeline(VideoDepthPipeline):
    """``VideoDepthPipeline`` with the windows split over the grid's data
    groups and, with ``model_parallel > 1`` (or a grid whose model groups
    have more than one rank), the encoder split over each model group.
    ``grid`` defaults to ``create_grid(model=model_parallel)`` over the
    started world (one rank when none was started).  ``decoded`` is the
    frame range this rank decoded in the last call."""

    def __init__(self, model, input_size: int = 518, grid: Optional[Grid] = None,
                 shape_bucket: Optional[int] = None, model_parallel: int = 1,
                 window_batch: Optional[int] = None, host_upsample: Optional[bool] = None,
                 transfer_dtype: Optional[str] = None):
        super().__init__(model, input_size, shape_bucket, window_batch=window_batch,
                         host_upsample=host_upsample, transfer_dtype=transfer_dtype)
        self.grid = grid if grid is not None else create_grid(model=model_parallel)
        self.decoded = None

    def _prepare_model(self) -> None:
        """Split the encoder over the model group (once)."""
        shard_module(self.model.module, self.grid)

    def infer_video_depth(self, frames: np.ndarray, target_fps: float = -1,
                          skip_tmp_block: bool = False, progress: bool = False):
        """``infer_frame_range`` over frames already in memory."""
        return self.infer_frame_range(len(frames), lambda a, b: frames[a:b], target_fps,
                                      skip_tmp_block=skip_tmp_block, progress=progress)

    def infer_frame_range(self, n_frames: int, decode_range: Callable[[int, int], np.ndarray],
                          target_fps: float = -1, skip_tmp_block: bool = False,
                          progress: bool = False):
        """``decode_range(a, b) -> uint8 (b − a, H, W, 3)`` returns sampled
        frames ``[a, b)`` of a video of ``n_frames``; this rank calls it for
        its data group's span only (one frame, for the exchange's shape,
        where the group has no window).  Returns (depth ``(n_frames, H,
        W)`` fp32, ``target_fps``) on every rank."""
        self._prepare_model()
        g = self.grid
        spans = host_window_spans(n_frames, g.data)
        span = spans[g.data_index]
        ours = span.window_stop > span.window_start
        self.decoded = (span.frame_start, min(span.frame_stop, n_frames)) if ours else (0, 1)
        frames = decode_range(*self.decoded)
        fh, fw = frames.shape[1:3]
        local: List[np.ndarray] = []
        if ours:
            # the last span reaches past n_frames: the global tail padding,
            # copies of the video's last frame, which is the span's last
            pre, wait_until, thread = self._preprocess_pipelined(
                frames, span.frame_stop - span.frame_start, self._target_hw(fh, fw))
            idx = window_frame_indices(n_frames)[span.window_start:span.window_stop]
            local = self.compute_window_depths(
                pre, idx - span.frame_start, fh, fw, skip_tmp_block=skip_tmp_block,
                progress=progress and comm.world().rank == 0, wait_until=wait_until,
                desc=f"windows of data group {g.data_index}/{g.data}")
            thread.join()
        depths = exchange_windows(local, spans, (INFER_LEN, fh, fw), g.data_group)
        return stitch_windows(depths, n_frames), target_fps
