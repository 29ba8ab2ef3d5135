"""Device selection, device→host transfers and kernel timing.

The port runs on the card unless the caller asks for the CPU, and never
drops to the CPU on its own.  ``resolve_transfer_dtype``, ``transfer_cast``
and ``start_host_transfer`` serve the pipelines' lagged emit: a depth map's
copy to the host starts as soon as it is enqueued and overlaps the next
step (the next window batch, in the window pipeline).  ``env_switch`` reads
the ``VDA_*`` switches as the JAX package does.
``card_line``, ``event_ms``, ``graph_ms`` and ``mem`` serve the bench
modules and ``chip_smoke.py``.
"""

from __future__ import annotations

import os
import subprocess
from typing import Optional

import numpy as np
import torch

TRANSFER_DTYPES = {"fp32": torch.float32, "fp16": torch.float16}


def resolve_transfer_dtype(name: Optional[str] = None) -> torch.dtype:
    """The dtype of emitted depth maps on their way to the host: ``name``
    (``fp32`` or ``fp16``) where given, else ``VDA_TRANSFER_DTYPE``
    (``fp16`` or ``float16`` → fp16), else fp32, as the JAX package reads
    it."""
    if name is None:
        env = os.environ.get("VDA_TRANSFER_DTYPE", "fp32")
        return torch.float16 if env in ("fp16", "float16") else torch.float32
    if name not in TRANSFER_DTYPES:
        raise ValueError(f"transfer_dtype must be fp32|fp16, got {name!r}")
    return TRANSFER_DTYPES[name]


def env_switch(value: Optional[bool], name: str, default: bool) -> bool:
    """``value`` where given, else the environment variable ``name`` read as
    the JAX package reads its switches: a switch on by ``default`` is off
    only at ``"0"`` (``VDA_DEVICE_ALIGN``), one off by default is on only
    at ``"1"`` (``VDA_HOST_UPSAMPLE``)."""
    if value is not None:
        return bool(value)
    env = os.environ.get(name)
    return env != "0" if default else env == "1"


def resolve_device(device=None) -> torch.device:
    """``None`` or ``"cuda"`` → the current CUDA device, raising when there
    is none; ``"cpu"`` (or any explicit device) is taken as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev


def transfer_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in the dtype of its device→host copy: fp16 halves the bytes of
    every emitted depth map (about 3 significant digits), fp32 keeps them."""
    return x if x.dtype == dtype else x.to(dtype)


class HostTransfer:
    """A device→host copy in flight: ``numpy()`` waits for it and returns
    fp32.  CPU tensors are taken as they are."""

    def __init__(self, x: torch.Tensor):
        if x.device.type == "cpu":
            self.host, self.event = x, None
            return
        self.host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        self.host.copy_(x, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.float().numpy()


def start_host_transfer(x: torch.Tensor) -> HostTransfer:
    """Start copying ``x`` into pinned host memory on the current stream,
    without blocking the host."""
    return HostTransfer(x)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def event_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Milliseconds per call of ``fn`` on the card: CUDA events around
    ``iters`` calls after ``warmup`` calls, synchronised."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(calls, reps: int = 20) -> float:
    """Device milliseconds per call: ``reps`` calls, taken in turn from
    ``calls`` (closures over copies of the inputs, so that a small kernel's
    inputs rotate through more bytes than the 50 MB L2 holds), captured
    into one CUDA graph and timed with CUDA events around a replay after a
    warm replay.  The host's launch path is not in the time, which is what
    a kernel of a few microseconds needs (``event_ms`` times the host too
    once a call's host work outlasts its kernel)."""
    for c in calls:
        c()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            calls[i % len(calls)]()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def mem(device=None) -> dict:
    """Device memory of the bench row being finished, in MB (the counterpart
    of the JAX ``bench.py`` ``_mem``): ``in_use_mb`` from
    ``torch.cuda.memory_allocated`` and ``peak_mb`` from
    ``torch.cuda.max_memory_allocated``.  The row calls
    ``torch.cuda.reset_peak_memory_stats()`` when it starts, so ``peak_mb``
    is the row's own high-water mark, where JAX's is the process's so far.
    Both count the tensors PyTorch's allocator holds, not its cache.  A
    row on the CPU has no device memory: ``{}``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return {}
    return {"in_use_mb": round(torch.cuda.memory_allocated(dev) / 2**20, 1),
            "peak_mb": round(torch.cuda.max_memory_allocated(dev) / 2**20, 1)}
