"""Run statistics (the JAX package's ``utils/stats.py``): one JSON record a
run appended to a log (``run --save_stats``), and the progress counter of
the pipelines' ``progress=True`` (on stderr: the card's machine has no
progress-bar package)."""

from __future__ import annotations

import datetime
import json
import os
import resource
import sys
from typing import Mapping

import torch


def device_memory_stats(device=None) -> dict:
    """Memory of the current CUDA device in MB, under the device's name:
    allocated (``bytes_in_use_mb``), reserved by the allocator's cache
    (``bytes_reserved_mb``) and the allocated peak (``peak_bytes_in_use_mb``).
    ``{}`` when ``device`` is the CPU or no card is present."""
    if device is not None and torch.device(device).type != "cuda":
        return {}
    if not torch.cuda.is_available():
        return {}
    i = torch.cuda.current_device()
    return {f"cuda:{i}": {
        "bytes_in_use_mb": torch.cuda.memory_allocated(i) / 2**20,
        "bytes_reserved_mb": torch.cuda.memory_reserved(i) / 2**20,
        "peak_bytes_in_use_mb": torch.cuda.max_memory_allocated(i) / 2**20,
    }}


def host_rss_mb() -> float:
    """Peak resident set size of this process in MB (Linux reports KB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def append_run_log(path: str, args: Mapping, n_frames: int, n_depths: int, wall_s: float,
                   device=None) -> None:
    """Append one record of a run to ``path``, in the JAX record's keys."""
    rec = {
        "timestamp": datetime.datetime.now().isoformat(timespec="seconds"),
        "args": dict(args),
        "frames_decoded": n_frames,
        "frames_predicted": n_depths,
        "wall_s": round(wall_s, 3),
        "fps_end_to_end": round(n_depths / wall_s, 3) if wall_s else None,
        "host_peak_rss_mb": round(host_rss_mb(), 1),
        "device_memory": device_memory_stats(device),
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


class Progress:
    """``desc: done/total`` rewritten in place on stderr as work completes;
    silent unless ``enabled``."""

    def __init__(self, total: int, desc: str, enabled: bool = True):
        self.total, self.desc, self.enabled, self.done = total, desc, enabled, 0

    def update(self, n: int = 1) -> None:
        self.done += n
        if self.enabled:
            sys.stderr.write(f"\r{self.desc}: {self.done}/{self.total}")
            sys.stderr.flush()

    def close(self) -> None:
        if self.enabled:
            sys.stderr.write("\n")
            sys.stderr.flush()
