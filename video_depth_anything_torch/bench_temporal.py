"""Kernel B (temporal attention) on the card, alone, at the main path's
shapes (``chip_smoke.py`` phase kernels' rows, then the vits and vitb
window calls at the pipeline's batch of 4 windows): device ms per launch
beside its bytes bound, the plain version's and SDPA's ms, and the split
(the kernel's copies alone).

    python -m video_depth_anything_torch.bench_temporal [--root DIR] [--parent-stop]
        [--any [--dtype fp32|bf16]] [--iters N]

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
earlier kernel that PERF.md section 6 records.

``--any`` times the run-time-d kernel instead, at the 43 (C, heads) of
``chip_smoke.py`` phase domain's sweep that are off the six instantiated
widths (B = 1, T = 32, S = 74² or 19² at C ≥ 640), in fp32 (the default)
or bf16: device ms, the bound (the larger of the bytes over 3.35 TB/s and
the softmax's B·S·heads·T² exponentials at 16 a clock on every SM at the
card's largest SM clock), plain and SDPA ms, ``split_ms``.  With
``--parent-stop`` a tree whose split does not take the run-time-d kernel
(the earlier design, both dtypes in one ``csrc/temporal_attention_any.cu``)
is split by building that source with its unit loop dropped.  Prints the
card's name and power limit and the ``[ptxas]`` lines (registers, spills)
of the tree's Kernel B, then one JSON row per shape.
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
SFU_PER_CLOCK = 16  # exp2 (MUFU.EX2) results a clock on one SM
# --any: chip_smoke.py phase domain's sweep (DOMAIN_B_HEADS, DOMAIN_S, DOMAIN_S_WIDE)
ANY_HEADS = (4, 8, 16)
ANY_S, ANY_S_WIDE = 74 * 74, 19 * 19
# the one-frame-per-lane kernel's compute guard, which --parent-stop puts behind KB_STOP
_PARENT_GUARD = "  if (t < T) {\n    const int col = h * DH;"
# the earlier run-time-d kernel's unit loop (both dtypes in one source), which --any
# --parent-stop drops
_ANY_GUARD = "    for (int u = first; u - first < units; u += per) {"


def any_shapes(ta) -> list:
    """(C, heads) of phase domain's Kernel B sweep off the six instantiated
    widths: every multiple of 8 up to 2048 that the gate admits under
    ``pallas`` at 4, 8 and 16 heads (43 of them)."""
    return [(c, h) for h in ANY_HEADS for c in range(8, 2049, 8)
            if ta.temporal_gate((1, 32, ANY_S, c), h, auto=False) and not ta.instantiated(c, h)]


def sfu_ms(b: int, s: int, heads: int, t: int) -> float:
    """ms for the softmax's B·S·heads·T² exponentials at SFU_PER_CLOCK a
    clock on every SM of card 0 at its largest SM clock."""
    import torch

    from video_depth_anything_torch.bench_probe_split import max_sm_clock_hz

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return float(b) * s * heads * t * t / (SFU_PER_CLOCK * sms * max_sm_clock_hz()) * 1e3


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


def parent_stop_kernel(root: str, any_symbol: str = ""):
    """The one-frame-per-lane ``temporal_attention.cu`` of ``root`` built with its
    attention dropped: returns ``(fn, ptxas lines)``, ``fn`` with the
    one-frame-per-lane C signature.  With ``any_symbol``, the earlier
    ``temporal_attention_any.cu`` of ``root`` (both dtypes in one source)
    built with its unit loop dropped, ``fn`` its entry ``any_symbol`` (the
    run-time-d signature)."""
    from video_depth_anything_torch.ops import cuda_build

    src_dir = os.path.join(root, "video_depth_anything_torch", "csrc")
    name, guard = ("temporal_attention_any", _ANY_GUARD) if any_symbol else \
        ("temporal_attention", _PARENT_GUARD)
    text = open(os.path.join(src_dir, f"{name}.cu")).read()
    if text.count(guard) != 1:
        raise SystemExit(f"--parent-stop: the tree's {name}.cu is not the design it splits")
    stopped = guard.replace("for (int u = first; u", "for (int u = first; !KB_STOP && u") \
        if any_symbol else guard.replace("if (t < T)", "if (!KB_STOP && t < T)")
    text = "#ifndef KB_STOP\n#define KB_STOP 0\n#endif\n" + text.replace(guard, stopped)
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
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn = getattr(ctypes.CDLL(so), f"vda_{any_symbol}" if any_symbol else "vda_temporal_attention")
    fn.argtypes = [vp, vp, vp, vp, i, i, i, i, i, ctypes.c_float] + ([i, i] if any_symbol else []) \
        + [vp]
    fn.restype = ctypes.c_int
    return fn, lines


def any_rows(args, root: str, ta, cuda_build, dev) -> None:
    """``--any``: the run-time-d kernel at ``any_shapes``, one JSON row each."""
    import torch
    import torch.nn.functional as F

    from video_depth_anything_torch.utils.device import graph_ms

    f32 = args.dtype == "fp32"
    symbol = "temporal_attention_any" + ("_f32" if f32 else "")
    stop_fn = None
    if args.parent_stop:
        stop_fn, lines = parent_stop_kernel(root, symbol)
        for ln in lines:
            print(f"[ptxas] {symbol} stopped: {ln}", flush=True)
    split = getattr(ta, "temporal_attention_split", None)
    for n, (c, heads) in enumerate(any_shapes(ta)):
        s = ANY_S if c < 640 else ANY_S_WIDE
        d = c // heads
        scale = d**-0.5
        copies = inputs(1, 32, s, c, 300 + n, dev)
        if f32:
            copies = [tuple(x.float() for x in cp) for cp in copies]
        q, k, v = copies[0]
        bytes_ms = 4.0 * 32 * s * c * q.element_size() / PEAK_BYTES * 1e3
        exp_ms = sfu_ms(1, s, heads, 32)
        row = {"kernel": symbol, "shape": f"domain (B=1, T=32, S={s}, C={c}, heads={heads}, d={d})",
               "d": d, "bytes_ms": bytes_ms, "sfu_ms": exp_ms, "bound_ms": max(bytes_ms, exp_ms),
               "bound_by": "bytes" if bytes_ms >= exp_ms else "operations"}
        try:
            got = ta.temporal_attention(q, k, v, heads, scale)
        except (NotImplementedError, RuntimeError) as e:
            row["error"] = str(e).splitlines()[0]
        if "error" not in row:
            row["ms"] = graph_ms([lambda x=x: ta.temporal_attention(*x, heads, scale)
                                  for x in copies], args.iters)
            want = ta.temporal_attention_plain(q, k, v, heads, scale).float()
            row["rel_err"] = float((got.float() - want).abs().max() / want.abs().max())
            if stop_fn is not None:
                locs, group = ta.tile_plan(c, heads, q.element_size())

                def stopped(x):
                    out = torch.empty_like(x[0])
                    err = stop_fn(*(cuda_build.ptr(y) for y in x), cuda_build.ptr(out), 1, 32, s,
                                  c, heads, float(scale), locs, group, cuda_build.stream_of(x[0]))
                    cuda_build.check(err, f"stopped {symbol}")
                    return out
                row["split_ms"] = {"copies": graph_ms([lambda x=x: stopped(x) for x in copies],
                                                      args.iters)}
            elif split is not None:
                try:  # a tree whose split takes only the instantiated kernel raises here
                    row["split_ms"] = {"copies": graph_ms([lambda x=x: split(*x, heads, scale)
                                                           for x in copies], args.iters)}
                except ValueError as e:
                    row["split_ms"] = {"error": str(e)}
        row["plain_ms"] = graph_ms([lambda: ta.temporal_attention_plain(q, k, v, heads, scale)], 3)
        q5, k5, v5 = (x.view(1, 32, s, heads, d).permute(0, 2, 3, 1, 4) for x in (q, k, v))
        row["library_ms"] = graph_ms(
            [lambda: F.scaled_dot_product_attention(q5, k5, v5, scale=scale)], 5)
        if "ms" in row:
            row["ms_over_bound"] = row["ms"] / row["bound_ms"]
            row["ms_over_library"] = row["ms"] / row["library_ms"]
        print(json.dumps(row), flush=True)
        del copies, q, k, v, q5, k5, v5
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None, help="checkout to import the port from")
    ap.add_argument("--parent-stop", action="store_true",
                    help="time the one-frame-per-lane kernel's copies alone (a tree "
                         "without a split entry)")
    ap.add_argument("--any", action="store_true",
                    help="the run-time-d kernel at phase domain's 43 widths")
    ap.add_argument("--dtype", choices=("fp32", "bf16"), default="fp32",
                    help="--any's operand type")
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
    names = [n for n in cuda_build.SOURCES if n.startswith("temporal_attention")] if args.any \
        else ["temporal_attention"]
    for name in names:
        for ln in ptxas_lines(cuda_build.BUILD_DIR, name):
            print(f"[ptxas] {name}: {ln}", flush=True)
    dev = torch.device("cuda")
    if args.any:  # the plain version and SDPA in full fp32 (TF32 off)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        any_rows(args, root, ta, cuda_build, dev)
        return 0
    split = getattr(ta, "temporal_attention_split", None)
    stop_fn = None
    if split is None and args.parent_stop:
        stop_fn, lines = parent_stop_kernel(root)
        for ln in lines:
            print(f"[ptxas] temporal_attention stopped: {ln}", flush=True)
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
