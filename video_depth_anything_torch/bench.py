"""The port's benchmark: the JAX package's ``bench.py`` contract on the card.

    python -m video_depth_anything_torch.bench

Prints the card's name and power limit (``utils/device.card_line``), then
the headline line, flushed at once: frames/s of the vits 1x32x518x518 bf16
window (``bench_window("vits")``), ``vs_baseline`` against the reference's
A100 FP16 Small number (7.5 ms a frame: 133.33 frames/s).  Then the extra
rows of ``EXTRA_ROWS``, most important first, under a wall-clock budget
(``VDA_BENCH_BUDGET_S``, default 480 s from the start; rows past it are
``"SKIPPED: time budget"``), and the full line (the headline fields and
every row) when they finish.  ``VDA_BENCH_FAST=1`` prints the headline
line only.  A row that raises is recorded as ``"ERROR: <type>: <msg>"`` and
``main`` then returns 1.

The rows are the JAX ``bench.py``'s, with its keys, parameters, defaults
and fields, except:

- timing: ``warmup`` calls, ``torch.cuda.synchronize()``, then the wall
  clock around ``iters`` back-to-back calls closed by one
  ``synchronize()`` (JAX dispatches the same way and forces the last call
  through a scalar tap);
- ``compile_s`` is the first call's seconds, the kernels' nvcc build
  included when ``video_depth_anything_torch/_build/`` is cold;
- ``mem_static`` is left out (eager PyTorch has no compiler byte
  accounting); ``mem`` is ``utils/device.mem``: the row's own peak, where
  JAX's is the process's high-water mark;
- ``dp_vits`` runs the data-parallel window forward over the ranks the
  process has (``parallel/``; one rank, on one card, when the bench is run
  as a single process), and its ``detail`` says how many.

Inputs are seeded noise from an explicit ``torch.Generator`` (seed 0) and
the weights ``init_params(seed=0)``, as JAX's; the train row is
``profile_train.train_setup`` with the encoder frozen, as JAX's default
``Trainer``.  Every row function takes ``device`` (None: the card);
``main`` runs on the card only and raises without one.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time

import torch

from video_depth_anything_torch.utils.device import card_line, mem, resolve_device

BASELINE_FPS_A100_FP16_SMALL = 1000.0 / 7.5  # per-frame ms -> frames/s


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _start(device) -> torch.device:
    """The row's device, its peak-memory counter reset."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    return dev


def _timed(call, iters: int, warmup: int, device) -> tuple:
    """``(first_call_s, s_per_call)``: one call timed alone, ``warmup``
    more, a synchronise, then ``iters`` back-to-back calls closed by one
    synchronise."""
    t0 = time.perf_counter()
    call()
    _sync(device)
    first = time.perf_counter() - t0
    for _ in range(warmup):
        call()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        call()
    _sync(device)
    return first, (time.perf_counter() - t0) / iters


def bench_window(encoder: str = "vits", size: int = 518, frames: int = 32,
                 iters: int = 10, warmup: int = 3, batch: int = 1,
                 attn_impl: str = "auto", device=None) -> dict:
    """``batch`` windows of ``frames`` square frames a call
    (``VDAModel.infer_window``, bf16); ``attn_impl="auto:fast"`` takes
    Kernel A's no-max softmax."""
    from video_depth_anything_torch.models.vda import VDAModel

    dev = _start(device)
    model = VDAModel(encoder, device=dev, attn_impl=attn_impl)
    model.init_params(seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(batch, frames, size, size, 3, device=dev, generator=gen).to(torch.bfloat16)
    compile_s, med = _timed(lambda: model.infer_window(x), iters, warmup, dev)
    total = batch * frames
    return {
        "encoder": encoder,
        "size": size,
        "frames": frames,
        "batch": batch,
        "compile_s": round(compile_s, 2),
        "median_window_s": round(med, 4),
        "frames_per_s": round(total / med, 2),
        "ms_per_frame": round(1000.0 * med / total, 3),
        "mem": mem(dev),
    }


def bench_data_parallel(encoder: str = "vits", size: int = 518, frames: int = 32,
                        iters: int = 5, warmup: int = 2, device=None) -> dict:
    """Per-rank window throughput under the data-parallel window split
    (the JAX ``bench_data_parallel``): each rank of the started world (one
    when none was started) runs one ``frames``-frame window a call, and a
    call ends when every rank's has (a barrier), so ``frames_per_s_total``
    is the world's."""
    from video_depth_anything_torch.models.vda import VDAModel
    from video_depth_anything_torch.parallel import comm

    world = comm.world()
    dev = _start(device if device is not None or world.backend is None else world.device)
    model = VDAModel(encoder, device=dev)
    model.init_params(seed=0)
    gen = torch.Generator(device=dev).manual_seed(world.rank)
    x = torch.randn(1, frames, size, size, 3, device=dev, generator=gen).to(torch.bfloat16)

    def call():
        model.infer_window(x)
        comm.barrier()

    compile_s, med = _timed(call, iters, warmup, dev)
    total = world.size * frames
    return {
        "encoder": encoder,
        "devices": world.size,
        "compile_s": round(compile_s, 2),
        "frames_per_s_total": round(total / med, 2),
        "frames_per_s_per_chip": round(total / med / world.size, 2),
        "mem": mem(dev),
        "detail": (f"world size {world.size}, backend {world.backend or 'none'}: "
                   + ("one rank on one card, no collective" if world.size == 1 else
                      f"{world.size} ranks, one window each a call")),
    }


def bench_streaming(encoder: str = "vits", size: int = 518, iters: int = 20,
                    warmup: int = 3, chunk: int = 8, device=None) -> dict:
    """Steady feature-cache streaming (``profile_streaming.steady_step``):
    ``chunk`` frames a step on a full cache; seconds per step / chunk."""
    from video_depth_anything_torch.models.vda import VDAModel
    from video_depth_anything_torch.profile_streaming import steady_step

    dev = _start(device)
    model = VDAModel(encoder, device=dev)
    model.init_params(seed=0)
    step, k = steady_step(model, size, size, chunk, seed=0)
    compile_s, per_step = _timed(step, iters, warmup, dev)
    med = per_step / k
    return {
        "encoder": encoder,
        "size": size,
        "chunk": chunk,
        "compile_s": round(compile_s, 2),
        "median_step_s": round(med, 4),
        "frames_per_s": round(1.0 / med, 2),
        "mem": mem(dev),
    }


def bench_kv_streaming(encoder: str = "vits", size: int = 518, iters: int = 20,
                       warmup: int = 3, chunk: int = 1, aligned: bool = False,
                       device=None) -> dict:
    """Steady KV-cache streaming (``profile_streaming.steady_kv_step``):
    ``chunk`` frames a step on the caches the last step left; ``aligned``
    re-predicts the pinned anchor and fits (s, t) on the device each
    frame.  Seconds per step / chunk."""
    from video_depth_anything_torch.models.vda import VDAModel
    from video_depth_anything_torch.profile_streaming import steady_kv_step

    dev = _start(device)
    model = VDAModel(encoder, device=dev)
    model.init_params(seed=0)
    step, k = steady_kv_step(model, size, size, chunk, seed=0, aligned=aligned)
    compile_s, per_step = _timed(step, iters, warmup, dev)
    med = per_step / k
    return {
        "encoder": encoder,
        "size": size,
        "chunk": chunk,
        "aligned": aligned,
        "compile_s": round(compile_s, 2),
        "median_step_s": round(med, 4),
        "frames_per_s": round(1.0 / med, 2),
        "mem": mem(dev),
    }


def bench_train(encoder: str = "vits", size: int = 266, frames: int = 32,
                iters: int = 5, device=None) -> dict:
    """``Trainer.step`` throughput, encoder frozen (bf16, SSI + TGM losses),
    one clip of ``frames`` square frames a step: the first step, 2 more,
    then ``iters`` timed."""
    from video_depth_anything_torch.profile_train import train_setup

    dev = _start(device)
    trainer, batch = train_setup(encoder, size, frames, train_encoder=False, device=dev)
    t0 = time.perf_counter()
    loss = float(trainer.step(batch)["loss"])
    compile_s = time.perf_counter() - t0
    for _ in range(2):
        metrics = trainer.step(batch)
    float(metrics["loss"])
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        metrics = trainer.step(batch)
    float(metrics["loss"])
    _sync(dev)
    med = (time.perf_counter() - t0) / iters
    return {
        "encoder": encoder,
        "size": size,
        "frames": frames,
        "clips_per_step": 1,
        "compile_s": round(compile_s, 2),
        "step_s": round(med, 4),
        "clip_frames_per_s_per_chip": round(frames / med, 2),
        "loss": round(loss, 4),
        "mem": mem(dev),
    }


# Extra rows, most important first (JAX bench.py:458-478, the same keys in
# the same order): under the budget the high-value rows are the ones that
# survive.
EXTRA_ROWS = (
    ("vitl", lambda: bench_window("vitl")),
    ("kv_streaming_vits_chunked", lambda: bench_kv_streaming("vits", chunk=8)),
    ("kv_streaming_vits_aligned_chunked",
     lambda: bench_kv_streaming("vits", aligned=True, chunk=8)),
    ("vits_wb4", lambda: bench_window("vits", batch=4)),
    ("vitb", lambda: bench_window("vitb")),
    ("streaming_vits_chunked", lambda: bench_streaming("vits")),
    ("kv_streaming_vits", lambda: bench_kv_streaming("vits")),
    ("kv_streaming_vits_aligned", lambda: bench_kv_streaming("vits", aligned=True)),
    ("vitl_fast", lambda: bench_window("vitl", attn_impl="auto:fast")),
    ("vitb_wb4", lambda: bench_window("vitb", batch=4)),
    ("streaming_vits", lambda: bench_streaming("vits", chunk=1)),
    ("kv_streaming_vitb", lambda: bench_kv_streaming("vitb")),
    ("kv_streaming_vitl", lambda: bench_kv_streaming("vitl")),
    ("kv_streaming_vitl_chunked", lambda: bench_kv_streaming("vitl", chunk=8)),
    ("dp_vits", lambda: bench_data_parallel("vits")),
    ("train_vits", lambda: bench_train("vits")),
)


def main() -> int:
    t_start = time.time()
    budget_s = float(os.environ.get("VDA_BENCH_BUDGET_S", "480"))
    if not torch.cuda.is_available():
        raise RuntimeError("the bench measures the card and there is no CUDA device")
    print(card_line(), flush=True)

    r = bench_window("vits")
    fps = r["frames_per_s"]

    def line(detail):
        return json.dumps({
            "metric": "frames/sec/chip vits 1x32x518x518 bf16",
            "value": fps,
            "unit": "frames/s",
            "vs_baseline": round(fps / BASELINE_FPS_A100_FP16_SMALL, 3),
            "detail": detail,
        })

    # the headline first, flushed: a kill during the extra rows cannot lose it
    detail = {"window_vits": r}
    print(line(detail), flush=True)
    failed = False
    if os.environ.get("VDA_BENCH_FAST", "0") != "1":
        for key, fn in EXTRA_ROWS:
            if time.time() - t_start > budget_s:
                detail[key] = "SKIPPED: time budget"
                continue
            try:
                detail[key] = fn()
            except Exception as e:  # noqa: BLE001 - a row's failure is recorded, then fails main
                detail[key] = f"ERROR: {type(e).__name__}: {e}"
                failed = True
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            print(f"# bench row {key}: {detail[key]}", file=sys.stderr, flush=True)
        detail["elapsed_s"] = round(time.time() - t_start, 1)
        print(line(detail), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
