"""Where a window's time goes on the card.

    python -m video_depth_anything_torch.profile_window [--encoder vitb|vitl] \\
        [--height 518 --width 518] [--attn_impl pallas] [--fp32] [--plain]

Runs ``VDAModel.infer_window`` for ``--encoder`` (vits by default; noised
seeded weights, full width and depth) on ``window_batch`` windows of 32
frames (the pipeline's default: 4 for vits and vitb, 1 for vitl) under
``torch.profiler``, then prints: the wall time per call, the device busy
share (sum of kernel times over the wall time of the profiled calls), the
top kernels by device time, and the device time grouped by the port's
kernels versus everything else.  ``--attn_impl`` is the model's
(``auto`` by default; ``pallas`` sends every motion-module attention in
Kernel B's domain to it).  ``--fp32`` runs the model in fp32 (the fp32
kernels; TF32 off in matrix products and convolutions), ``--plain`` the
plain path (``ops.dispatch.plain_reference``) that the kernels are held
against.  ``--trace PATH`` also writes a chrome trace there.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from collections import defaultdict


PORT_KERNELS = ("flash_fwd_f32", "temporal_f32", "motion_f32", "flash_fwd", "flash_bwd",
                "temporal_hopper", "motion_hopper", "output_tail_hopper")


def category(name: str) -> str:
    """The port's kernels by name (Kernel A's forward is ``flash_fwd_hopper``
    at D = 64 and ``flash_fwd_kernel`` at D = 192, its fast instantiations
    apart; Kernel B is ``temporal_hopper``, Kernel C ``mm::motion_hopper``, the tail
    ``output_tail_hopper``; the fp32 kernels ``flash_fwd_f32``, ``temporal_f32``
    and ``motion_f32``); the plain PyTorch rest by kind."""
    if "flash_fwd" in name and "_f32" not in name and ("true" in name or "(bool)1" in name):
        return "flash_fwd (fast)"
    for k in PORT_KERNELS:
        if k in name:
            return k
    n = name.lower()
    if "upsample" in n:
        return "plain: bilinear resize"
    if "fprop" in n or "conv" in n:
        return "plain: convolution"
    if "gemm" in n or "nvjet" in n or "cutlass" in n:
        return "plain: GEMM"
    if "reduce" in n:
        return "plain: reductions (norm statistics)"
    if "copy" in n:
        return "plain: copies and dtype casts"
    return "plain: other elementwise"


def report(prof, iters: int, wall: float, top: int) -> None:
    """Print the device kernel time per call and its busy share of the
    host wall time ``wall`` (seconds per call), the time by group, and the
    top kernels, from a ``torch.profiler`` run of ``iters`` calls."""
    import torch

    # device-side events only (one per kernel launch): CPU ops would count
    # their kernels a second time
    by_name = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name][0] += e.device_time_total
            by_name[e.name][1] += 1
    total = sum(us for us, _ in by_name.values())
    groups = defaultdict(float)
    for name, (us, _) in by_name.items():
        groups[category(name)] += us
    dev_ms = total / iters / 1e3
    print(f"device kernel time {dev_ms:.2f} ms per call, busy share {dev_ms / (wall * 1e3):.3f}")
    for k, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  group {k}: {us / iters / 1e3:.2f} ms ({us / total:.3f})")
    print("top kernels by self device time (ms per call, launches per call, name):")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {us / iters / 1e3:9.3f}  {n // iters:5d}  {name[:110]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--encoder", type=str, default="vits", choices=["vits", "vitb", "vitl"])
    ap.add_argument("--height", type=int, default=518)
    ap.add_argument("--width", type=int, default=518)
    ap.add_argument("--window_batch", type=int, default=None,
                    help="windows per call (default: the pipeline's, 4 for vits/vitb, 1 for vitl)")
    ap.add_argument("--attn_impl", type=str, default="auto")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--trace", type=str, default=None, help="chrome trace output path")
    ap.add_argument("--fp32", action="store_true", help="the model in fp32 (TF32 off)")
    ap.add_argument("--plain", action="store_true", help="the plain path, no kernels")
    args = ap.parse_args(argv)

    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from video_depth_anything_torch.models.vda import VDAModel
    from video_depth_anything_torch.ops.dispatch import plain_reference

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    if args.fp32:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    model = VDAModel(args.encoder, attn_impl=args.attn_impl,
                     dtype=torch.float32 if args.fp32 else torch.bfloat16)
    if args.window_batch is None:
        args.window_batch = 4 if model.cfg.features <= 128 else 1
    model.init_params(seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.module.parameters():
            p.add_(torch.randn(p.shape, generator=gen).to(p.device) * 0.02)
    x = torch.randn(args.window_batch, 32, args.height, args.width, 3, device="cuda")
    with plain_reference() if args.plain else contextlib.nullcontext():
        model.infer_window(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.iters):
                model.infer_window(x)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / args.iters
    frames = args.window_batch * 32
    label = " ".join([args.attn_impl] + ["fp32"] * args.fp32 + ["plain path"] * args.plain)
    print(f"{smi}")
    print(f"{args.encoder} {label} {args.window_batch}x32x{args.height}x{args.width}: "
          f"{wall * 1e3:.2f} ms per call, {frames / wall:.1f} frames/s")
    report(prof, args.iters, wall, args.top)
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
