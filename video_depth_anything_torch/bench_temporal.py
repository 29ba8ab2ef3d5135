"""Kernel B (temporal attention) on the card, alone, at the main path's
shapes (``chip_smoke.py`` phase kernels' rows, then the vits and vitb
window calls at the pipeline's batch of 4 windows): device ms per launch
beside its bytes bound, the plain version's and SDPA's ms, and the split
(the kernel's copies alone).

    python -m video_depth_anything_torch.bench_temporal [--root DIR] [--parent-stop]
        [--iters N]

``--root`` imports the port's kernels from another checkout (for example
an unpacked parent commit; ``bench_motion_tail.use_root``), so that two
trees can be timed in turns on one card with this tree's timers; a width
the tree's kernel lacks prints an ``error`` row.  Times are ``graph_ms``
(device time, inputs rotated through more bytes than L2 holds);
``events_ms`` is the same launch timed with ``event_ms`` on one copy (host
launch path included), the method of the earlier tables.  ``split_ms``
times the copies in and out alone: the tree's
``temporal_attention_split`` where it has one, else with
``--parent-stop`` the tree's ``csrc/temporal_attention.cu`` of the
one-frame-per-lane design (the earlier kernel) built with its attention dropped
(loads and stores kept; the source's compute guard is rewritten behind a
``KB_STOP`` macro, so only that design is accepted): the split of the
earlier kernel that PERF.md section 6 records.  Prints the card's name
and power limit and the ``[ptxas]`` lines (registers, spills) of the
tree's Kernel B, then one JSON row per shape.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import tempfile

HEADS = 8
# (label, B, T, S, C): chip_smoke.py phase kernels' rows
SHAPES = (("vits m0 518x518", 1, 32, 1369, 192), ("vits m2 518x518", 1, 32, 1369, 64),
          ("vitb m2 518x518", 1, 32, 1369, 128), ("vits m1 518x518", 1, 32, 361, 384),
          ("vitb m0 518x518", 1, 32, 1369, 384), ("vitl m2 518x518", 1, 32, 1369, 256),
          ("vitl m0 518x518", 1, 32, 1369, 1024), ("vitl m0 518x924", 1, 32, 2442, 1024),
          ("ragged T=17", 1, 17, 101, 384), ("ragged T=17 C=64", 1, 17, 101, 64))
# and the calls of a vits or vitb window at the pipeline's window batch (4 windows)
WINDOW_SHAPES = (("vits m0 518x518 window batch 4", 4, 32, 1369, 192),
                 ("vits m2 518x518 window batch 4", 4, 32, 1369, 64),
                 ("vitb m2 518x518 window batch 4", 4, 32, 1369, 128))
QK_STD = 1.6  # chip_smoke.QK_STD: peaked softmax rows
L2_BYTES = 50 * 2**20
PEAK_BYTES = 3.35e12
# the one-frame-per-lane kernel's compute guard, which --parent-stop puts behind KB_STOP
_PARENT_GUARD = "  if (t < T) {\n    const int col = h * DH;"


def inputs(b, t, s, c, seed, dev):
    """``copies`` of bf16 (q, k, v), enough that one pass over them and
    their outputs moves more than twice the L2."""
    import torch

    per = 4 * b * t * s * c * 2
    copies = max(1, -(-2 * L2_BYTES // per))
    g = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for _ in range(copies):
        x = torch.randn(b, t, s, 3 * c, device=dev, generator=g)
        x[..., : 2 * c] *= QK_STD
        out.append(tuple(y.contiguous() for y in x.to(torch.bfloat16).split(c, dim=-1)))
    return out


def ptxas_lines(build_dir, name: str):
    path = os.path.join(build_dir, f"{name}.log")
    if not os.path.exists(path):
        return []
    return [ln.strip() for ln in open(path).read().splitlines()
            if "entry function" in ln or "registers" in ln or "spill" in ln]


def parent_stop_kernel(root: str):
    """The one-frame-per-lane ``temporal_attention.cu`` of ``root`` built with its
    attention dropped: returns ``(fn, ptxas lines)``, ``fn`` with the
    one-frame-per-lane C signature."""
    from video_depth_anything_torch.ops import cuda_build

    src_dir = os.path.join(root, "video_depth_anything_torch", "csrc")
    text = open(os.path.join(src_dir, "temporal_attention.cu")).read()
    if text.count(_PARENT_GUARD) != 1:
        raise SystemExit("--parent-stop: the tree's temporal_attention.cu is not the "
                         "one-frame-per-lane design")
    text = "#ifndef KB_STOP\n#define KB_STOP 0\n#endif\n" + text.replace(
        _PARENT_GUARD, _PARENT_GUARD.replace("if (t < T)", "if (!KB_STOP && t < T)"))
    tmp = tempfile.mkdtemp(prefix="kb_stop_")
    for f in os.listdir(src_dir):
        if f.endswith(".cuh"):
            with open(os.path.join(src_dir, f)) as a, open(os.path.join(tmp, f), "w") as b:
                b.write(a.read())
    cu, so = os.path.join(tmp, "kb_stop.cu"), os.path.join(tmp, "libkb_stop.so")
    open(cu, "w").write(text)
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-DKB_STOP=1", "-o", so, cu],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"--parent-stop: nvcc failed:\n{proc.stdout}{proc.stderr}")
    lines = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if "registers" in ln or "spill" in ln]
    fn = ctypes.CDLL(so).vda_temporal_attention
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, i, i, i, i, i, ctypes.c_float, vp]
    fn.restype = ctypes.c_int
    return fn, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None, help="checkout to import the port from")
    ap.add_argument("--parent-stop", action="store_true",
                    help="time the one-frame-per-lane kernel's copies alone (a tree "
                         "without a split entry)")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F

    # this tree's timers and loader; then the port from --root, if given
    from video_depth_anything_torch.bench_motion_tail import use_root
    from video_depth_anything_torch.utils.device import card_line, event_ms, graph_ms

    if args.root:
        use_root(args.root)
    from video_depth_anything_torch.ops import cuda_build
    from video_depth_anything_torch.ops import temporal_attention as ta

    if not torch.cuda.is_available():
        print("bench_temporal: no CUDA device", flush=True)
        return 3
    print(card_line(), flush=True)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(ta.__file__))))
    print(json.dumps({"root": root}), flush=True)
    cuda_build.build_all()
    ptxas = ptxas_lines(cuda_build.BUILD_DIR, "temporal_attention")
    for ln in ptxas:
        print(f"[ptxas] temporal_attention: {ln}", flush=True)
    split = getattr(ta, "temporal_attention_split", None)
    stop_fn = None
    if split is None and args.parent_stop:
        stop_fn, lines = parent_stop_kernel(root)
        for ln in lines:
            print(f"[ptxas] temporal_attention stopped: {ln}", flush=True)
    dev = torch.device("cuda")
    for n, (label, b, t, s, c) in enumerate(SHAPES + WINDOW_SHAPES):
        d = c // HEADS
        scale = d**-0.5
        copies = inputs(b, t, s, c, n, dev)
        q, k, v = copies[0]
        nbytes = 8.0 * b * t * s * c
        row = {"kernel": "temporal_attention", "shape": f"{label} (B={b}, T={t}, S={s}, C={c})",
               "d": d, "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes"}
        try:
            ta.temporal_attention(q, k, v, HEADS, scale)
        except (NotImplementedError, RuntimeError) as e:
            row["error"] = str(e).splitlines()[0]
        if "error" not in row:
            calls = [lambda x=x: ta.temporal_attention(*x, HEADS, scale) for x in copies]
            row["ms"] = graph_ms(calls, args.iters)
            row["events_ms"] = event_ms(calls[0], iters=args.iters)
            want = ta.temporal_attention_plain(q, k, v, HEADS, scale).float()
            got = ta.temporal_attention(q, k, v, HEADS, scale).float()
            row["rel_err"] = float((got - want).abs().max() / want.abs().max())
            if split is not None:
                stop = [lambda x=x: split(*x, HEADS, scale) for x in copies]
                row["split_ms"] = {"copies": graph_ms(stop, args.iters)}
        if stop_fn is not None and "error" not in row:
            def stopped(x):
                out = torch.empty_like(x[0])
                err = stop_fn(*(cuda_build.ptr(y) for y in x), cuda_build.ptr(out), b, t, s, c,
                              HEADS, float(scale), cuda_build.stream_of(x[0]))
                cuda_build.check(err, "stopped temporal_attention")
                return out
            row["split_ms"] = {"copies": graph_ms([lambda x=x: stopped(x) for x in copies],
                                                  args.iters)}
            row["split_ms"]["copies_events"] = event_ms(lambda: stopped(copies[0]),
                                                        iters=args.iters)
        row["plain_ms"] = graph_ms([lambda: ta.temporal_attention_plain(q, k, v, HEADS, scale)], 5)
        q5, k5, v5 = (x.view(b, t, s, HEADS, d).permute(0, 2, 3, 1, 4) for x in (q, k, v))
        row["library_ms"] = graph_ms(
            [lambda: F.scaled_dot_product_attention(q5, k5, v5, scale=scale)], args.iters)
        if "ms" in row:
            row["ms_over_bound"] = row["ms"] / row["bound_ms"]
        print(json.dumps(row), flush=True)
        del copies, q, k, v, q5, k5, v5
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
