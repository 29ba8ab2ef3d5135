"""Steady-state streaming on the card: frames/s and where a step's time
goes, for the feature-cache mode or, with ``--kv_cache``, the KV-cache mode.

    python -m video_depth_anything_torch.profile_streaming [--encoder vitb|vitl] \\
        [--height 518 --width 924] [--chunk 8] [--attn_impl auto:fast] [--kv_cache]

Times the steady step as the JAX package's ``bench.py`` does.  Feature
cache (``bench_streaming``): a full cache of ``L + max_kf − 1`` frames
(L = 32, keyframes (20,), the CLI's defaults), ``--chunk`` frames per step
(the chunked step; 1 is the per-frame step) and the steady gather indices.
KV cache (``bench_kv_streaming``): caches seeded by the warm-up window of
L = 32 frames, then ``--chunk`` frames per step (the chunked KV step: the
encoder over K frames, then K head steps; 1 is the per-frame KV step),
each step on the caches the previous one left.  Both take the host clock
around ``--iters`` synchronised steps after a warm-up: seconds per step ÷
chunk.  Weights are seeded and noised, frames are noise at the model size.
Then ``--iters`` more steps under ``torch.profiler`` give the device time
per step by group (``profile_window.report``).
"""

from __future__ import annotations

import argparse
import subprocess
import time


def steady_step(model, height: int, width: int, chunk: int, seed: int = 0):
    """``(step, k)``: a closure that runs one steady streaming step of
    ``k`` frames (``chunk`` clamped as the pipeline clamps it) on a full
    cache, and ``k``."""
    import torch

    from video_depth_anything_torch.inference.streaming import StreamingDepthPipeline

    pipe = StreamingDepthPipeline(model, inference_length=32, keyframe_list=(20,),
                                  chunk_size=chunk)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    k = pipe.chunk
    xs = torch.randn(k, height, width, 3, device=model.device, generator=gen).to(model.dtype)
    with torch.inference_mode():
        feats = model.module.encode_level_features(xs)
        cache = tuple(f[torch.arange(pipe.cache_len, device=f.device) % k].clone() for f in feats)
    out_hw = (height, width)
    if k > 1:
        gather, slots, _ = pipe._steady_indices(list(range(pipe.cache_len)), k)
        gather, slots = pipe._idx(gather), pipe._idx(slots)

        def step():
            with torch.inference_mode():
                return pipe._chunk_step(xs, cache, gather, slots, False, out_hw)
    else:
        use = pipe._idx(pipe.use_feature_idx[-1])
        slot = pipe._idx([pipe.cache_len - 1])

        def step():
            with torch.inference_mode():
                return pipe._step(xs, cache, use, slot, None, False, out_hw)
    return step, k


def steady_kv_step(model, height: int, width: int, chunk: int, seed: int = 0,
                   aligned: bool = False):
    """``(step, k)`` for the KV-cache mode: a closure that runs one steady
    KV step of ``k = chunk`` frames on the caches the previous call left
    (seeded by the warm-up window of L = 32 noise frames), and ``k``.
    ``aligned`` is the ``align_each_new_frame`` step (JAX ``bench.py``
    ``bench_kv_streaming(aligned=True)``): the first warm-up frame pinned as
    the anchor, predicted again at every step, and (s, t) fitted to its
    warm-up depth on the device."""
    import torch

    from video_depth_anything_torch.inference.kv_streaming import KVStreamingPipeline

    pipe = KVStreamingPipeline(model, inference_length=32, stream_chunk=chunk,
                               align_each_new_frame=aligned)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    k = pipe.chunk
    out_hw = (height, width)
    warm, xs = (torch.randn(n, height, width, 3, device=model.device, generator=gen).to(model.dtype)
                for n in (pipe.L, k))
    with torch.inference_mode():
        depth0, caches = pipe.start(warm[None], False, out_hw)
        anchor = model.module.encode_level_features(warm[:1]) if aligned else None
    state = [caches]

    def step():
        with torch.inference_mode():
            if k > 1:
                depth, state[0] = pipe.chunk_step(xs, state[0], False, out_hw, anchor,
                                                  depth0[0] if aligned else None)
            elif aligned:
                depth, state[0] = pipe.aligned_step(xs, state[0], anchor, depth0[0], False, out_hw)
            else:
                depth, state[0] = pipe.step(xs, state[0], False, out_hw)
        return depth
    return step, k


def seconds_per_frame(step, k: int, iters: int = 5, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters / k


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--encoder", type=str, default="vits", choices=["vits", "vitb", "vitl"])
    ap.add_argument("--height", type=int, default=518)
    ap.add_argument("--width", type=int, default=518)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--attn_impl", type=str, default="auto")
    ap.add_argument("--kv_cache", action="store_true", help="the KV-cache mode's steady step")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--trace", type=str, default=None, help="chrome trace output path")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from video_depth_anything_torch.models.vda import VDAModel
    from video_depth_anything_torch.profile_window import report

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    model = VDAModel(args.encoder, attn_impl=args.attn_impl)
    model.init_params(seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.module.parameters():
            p.add_(torch.randn(p.shape, generator=gen).to(p.device) * 0.02)
    make = steady_kv_step if args.kv_cache else steady_step
    step, k = make(model, args.height, args.width, args.chunk)
    spf = seconds_per_frame(step, k, args.iters)
    print(smi)
    mode = "kv_cache" if args.kv_cache else "feature cache"
    print(f"{args.encoder} {args.height}x{args.width} {args.attn_impl} {mode} chunk {k}: "
          f"{spf * k * 1e3:.2f} ms per step, {spf * 1e3:.3f} ms per frame, {1 / spf:.2f} frames/s")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.iters
    report(prof, args.iters, wall, args.top)
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
