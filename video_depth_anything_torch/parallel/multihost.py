"""Multi-host start-up and the span of frames each data group decodes (the
JAX package's ``parallel/multihost.py``).

``initialize_distributed`` starts the process group from the multi-host
flags (``comm.init_distributed``) and is a no-op returning ``(0, 1)``
without them.  ``host_window_spans`` is JAX's, copied: window ``w`` reads
frames up to ``w·step + 31`` and, through the keyframe splice, frames of
earlier windows, so each span decodes from the lowest frame its windows
use.  The data groups of the grid are the "hosts": the pipeline that
gives each one its span, decodes only that span and exchanges the depths
(JAX's ``MultiHostVideoDepthPipeline``) is
``data_parallel.DataParallelVideoDepthPipeline.infer_frame_range``, since
``--data_parallel`` and the multi-host flags are one mechanism here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from video_depth_anything_torch.inference.pipeline import (
    num_windows,
    padded_length,
    window_frame_indices,
)
from video_depth_anything_torch.parallel import comm


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, device=None) -> Tuple[int, int]:
    """Start the multi-host process group; returns ``(process_id,
    num_processes)``.  Without a coordinator and with at most one process
    this is a no-op returning ``(0, 1)``."""
    if coordinator_address is None and num_processes in (None, 1):
        return 0, 1
    w = comm.init_distributed(coordinator_address, num_processes, process_id, device=device)
    return w.rank, w.size


@dataclasses.dataclass(frozen=True)
class HostWindowSpan:
    """The contiguous window range a host owns, plus the frame range it must
    decode (windows reference earlier frames through the keyframe splice, so
    the decode span starts at the anchor frame 0's window chain)."""

    window_start: int
    window_stop: int
    frame_start: int
    frame_stop: int


def host_window_spans(n_frames: int, n_hosts: int) -> list:
    """Partition a video's windows across hosts (JAX ``host_window_spans``):
    contiguous ``linspace`` window bounds, and for each non-empty span the
    lowest and highest (exclusive, at most the padded length) frame its
    windows' splice-resolved inputs use."""
    n_win = num_windows(n_frames)
    idx = window_frame_indices(n_frames)
    bounds = np.linspace(0, n_win, n_hosts + 1).astype(int)
    spans = []
    for h in range(n_hosts):
        a, b = int(bounds[h]), int(bounds[h + 1])
        if a == b:
            spans.append(HostWindowSpan(a, b, 0, 0))
            continue
        used = idx[a:b]
        spans.append(HostWindowSpan(a, b, int(used.min()),
                                    min(int(used.max()) + 1, padded_length(n_frames))))
    return spans
