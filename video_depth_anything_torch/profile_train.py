"""Training throughput on the card, and where a training step's time goes.

    python -m video_depth_anything_torch.profile_train [--encoder vits] \\
        [--size 518 --frames 32] [--frozen_encoder]

Runs ``Trainer.step`` (noised seeded weights, full width and depth, the
encoder trained unless ``--frozen_encoder``, one clip of ``--frames``
square frames per step, synthetic data made on the card) and prints:
clips/s and frames/s of the kernel path and of the plain path
(``ops.dispatch.plain_reference()``), timed in turns (plain, kernel,
kernel, plain) with the peak device memory of each; the profile of the
kernel path's steps (``profile_window.report``: busy share, time by group,
top kernels); and the time to rebuild Kernel C's weights
(``TemporalModule.kernel_weights``), which every optimizer step pays once
per module that Kernel C runs (host clock around a synchronised rebuild).
"""

from __future__ import annotations

import argparse
import subprocess
import time


def train_setup(encoder: str, size: int, frames: int, train_encoder: bool = True, device=None):
    """``(trainer, batch)``: a bf16 ``Trainer`` over ``encoder`` at full
    width and depth (seeded weights with seeded noise; the encoder trained
    unless ``train_encoder`` is False) and one clip of ``frames`` square
    ``size`` frames made on ``device`` (None: the card): noise frames, a
    ramp of disparity, a full mask."""
    import torch

    from video_depth_anything_torch.models.vda import VDAModel
    from video_depth_anything_torch.train.trainer import Trainer, make_optimizer

    model = VDAModel(encoder, device=device)
    model.init_params(seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.module.parameters():
            p.add_(torch.randn(p.shape, generator=gen).to(p.device) * 0.02)
    trainer = Trainer(model.module, make_optimizer(1e-5, train_encoder=train_encoder),
                      train_encoder=train_encoder)
    dev, t, s = model.device, frames, size
    g = torch.Generator(device=dev).manual_seed(2)
    yy, xx = torch.meshgrid(torch.linspace(0, 1, s, device=dev),
                            torch.linspace(0, 1, s, device=dev), indexing="ij")
    batch = {"frames": torch.randn(1, t, s, s, 3, device=dev, generator=g),
             "disparity": (0.3 + 0.5 * xx + 0.2 * yy).expand(1, t, s, s).contiguous(),
             "mask": torch.ones(1, t, s, s, device=dev)}
    return trainer, batch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--encoder", default="vits", choices=["vits", "vitl"])
    ap.add_argument("--size", type=int, default=518)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--frozen_encoder", action="store_true")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from video_depth_anything_torch.ops.dispatch import plain_reference
    from video_depth_anything_torch.ops.motion_module import motion_gate
    from video_depth_anything_torch.profile_window import report

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    train_encoder = not args.frozen_encoder
    trainer, batch = train_setup(args.encoder, args.size, args.frames, train_encoder)
    t, s = args.frames, args.size

    def steps_per_s(n: int) -> float:
        trainer.step(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            m = trainer.step(batch)
        float(m["loss"])
        torch.cuda.synchronize()
        return n / (time.perf_counter() - t0)

    label = f"{args.encoder} 1x{t}x{s}x{s}, {'encoder trained' if train_encoder else 'encoder frozen'}"
    print(smi)
    rates = {"kernel": [], "plain": []}
    peaks = {}
    for path in ("plain", "kernel", "kernel", "plain"):
        torch.cuda.reset_peak_memory_stats()
        try:
            if path == "plain":
                with plain_reference():
                    rates[path].append(steps_per_s(args.iters))
            else:
                rates[path].append(steps_per_s(args.iters))
        except torch.cuda.OutOfMemoryError:
            print(f"{label}: {path} path out of device memory")
            torch.cuda.empty_cache()
            continue
        peaks[path] = torch.cuda.max_memory_allocated() / 2**30
    for path, r in rates.items():
        if r:
            print(f"{label}, {path} path: " + ", ".join(f"{x:.3f}" for x in r) + " clips/s ("
                  + ", ".join(f"{x * t:.1f}" for x in r) + f" frames/s), peak device memory "
                  f"{peaks[path]:.2f} GiB ({smi})")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            m = trainer.step(batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.iters
    print(f"{label}: {wall * 1e3:.2f} ms per step under the profiler")
    report(prof, args.iters, wall, args.top)

    ph = s // 14
    sides = (ph, (ph + 1) // 2, ph, 2 * ph)  # the maps of motion modules 0-3
    for i, (mod, side) in enumerate(zip(trainer.module.head.motion_modules, sides)):
        hw = (side, side)
        if not motion_gate(mod.cfg, mod.channels, mod.inner, t, *hw):
            continue
        times = []
        for _ in range(5):
            with torch.no_grad():
                mod.temporal_transformer.proj_in.weight.add_(0.0)  # a new version: rebuild
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mod.kernel_weights()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        print(f"Kernel C weight rebuild, motion module {i} ({hw[0]}x{hw[1]}, C={mod.channels}): "
              f"{min(times):.4f} ms (min of 5; once per optimizer step) ({smi})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
