"""Profiling utilities, the JAX package's ``utils/profiling.py`` on
``torch.profiler`` (the reference's ``Test_singleImage_processing.py:204-254``:
parameters split encoder against head, the cost of a window, timings by
component, profiler traces).

``compiled_cost`` differs from JAX's, which reads XLA's cost analysis of
the compiled program.  PyTorch has no such analysis, so the function is run
once on the plain path (``ops.dispatch.plain_reference``: the hand-written
kernels are ctypes calls that no PyTorch counter sees) and counted op by
op: FLOPs by ``torch.utils.flop_counter.FlopCounterMode`` (matrix products,
convolutions and attention at 2 FLOPs a multiply-add; elementwise ops,
norms, softmax and resizes count 0, where XLA counts them too), bytes as
each op's tensor inputs read once and outputs written once (views move
none; XLA counts its fused ops' operands, so it reports fewer bytes), and
the peak as the device's allocation peak above what was allocated before
the call (``torch.cuda.max_memory_allocated``; XLA's temporary buffers).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


# Reference state-dict keys that no forward reads and that the JAX param
# tree therefore lacks (``io/checkpoint.from_jax_params`` zero-fills them):
# DINOv2's mask token, and the skip unit of refinenet4, which takes no skip.
DEAD_AT_INFERENCE = ("pretrained.mask_token", "head.scratch.refinenet4.resConfUnit1.")


def param_counts(module: torch.nn.Module) -> Dict[str, float]:
    """Parameter counts (M) split encoder (``pretrained.*``) against head
    (``head.*``), as JAX's over its ``pretrained`` and ``head`` subtrees:
    the parameters a forward reads (``DEAD_AT_INFERENCE`` left out).
    Reads shapes only, so a module on the ``meta`` device will do."""
    enc = head = total = 0
    for name, p in module.named_parameters():
        if name.startswith(DEAD_AT_INFERENCE):
            continue
        total += p.numel()
        if name.startswith("pretrained."):
            enc += p.numel()
        elif name.startswith("head."):
            head += p.numel()
    return {"encoder_Mparams": enc / 1e6, "head_Mparams": head / 1e6, "total_Mparams": total / 1e6}


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of every op's tensor inputs and outputs; views count
    nothing."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            leaves = tree_flatten((args, kwargs or {}))[0] + tree_flatten(out)[0]
            self.bytes += sum(t.nbytes for t in leaves if isinstance(t, torch.Tensor))
        return out


def _sync(device: Optional[torch.device] = None) -> None:
    if (device is None or device.type == "cuda") and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def compiled_cost(fn: Callable, *args) -> Dict[str, Optional[float]]:
    """GFLOPs, GB accessed and peak MB of one call of ``fn(*args)`` on the
    plain path (see the module's docstring for how these differ from XLA's
    cost analysis).  ``peak_mb`` is ``None`` off the card."""
    from torch.utils.flop_counter import FlopCounterMode

    from video_depth_anything_torch.ops.dispatch import plain_reference

    cuda = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    counter = FlopCounterMode(display=False)
    with torch.inference_mode(), plain_reference(), counter, _ByteCounter() as nbytes:
        fn(*args)
    out = {"gflops": counter.get_total_flops() / 1e9, "gbytes_accessed": nbytes.bytes / 1e9,
           "peak_mb": None}
    if cuda:
        torch.cuda.synchronize()
        out["peak_mb"] = (torch.cuda.max_memory_allocated() - base) / 2**20
    return out


def time_fn(fn: Callable, iters: int = 5, warmup: int = 2) -> Dict[str, float]:
    """Median wall time of ``fn``; the card is synchronised inside each
    timed call, so queued launches are paid for."""
    def call():
        fn()
        _sync()

    for _ in range(warmup):
        call()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        call()
        ts.append(time.perf_counter() - t0)
    return {"median_s": float(np.median(ts)), "min_s": float(np.min(ts)), "iters": iters}


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """``torch.profiler`` over the block (CPU, and the card where there is
    one); its Chrome trace is written to ``log_dir/trace.json`` (open it in
    ``chrome://tracing`` or Perfetto)."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * torch.cuda.is_available()
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def component_timings(model, frames: int = 32, size: int = 518) -> Dict[str, Dict]:
    """Times of the encoder alone and of the whole window forward at one
    ``(1, frames, size, size)`` window of the model's dtype on its device;
    the head's is their difference."""
    x = torch.zeros(1, frames, size, size, 3, device=model.device, dtype=model.dtype)
    flat = x.reshape(frames, size, size, 3)
    module, idx = model.module, model.cfg.intermediate_layer_idx

    def enc():
        with torch.inference_mode():
            module.pretrained(flat, idx)

    def full():
        with torch.inference_mode():
            module(x)

    results = {"encoder": time_fn(enc), "full": time_fn(full)}
    results["head_derived_s"] = round(results["full"]["median_s"]
                                      - results["encoder"]["median_s"], 4)
    return results
