"""The fp32 Kernels A, B and C on the card, alone, at ``chip_smoke.py``
phase fp32's shapes: Kernel A at vits 32×1370 and 32×2443 (6 heads of 64,
exact and fast) and at D = 192 (2 heads, exact at 1370 and fast at 2443),
Kernel B at ``bench_temporal``'s shapes (its rows, then the window calls at
the pipeline's batch of 4), Kernel C at its nine rows (``MOTION_SHAPES``).
Device ms per launch (``graph_ms``, inputs rotated through more bytes than
L2 holds) beside the bounds, SDPA's ms in fp32 (TF32 off: the yardstick)
and the error against the plain version.

    python -m video_depth_anything_torch.bench_fp32 [--root DIR] [--iters N]
        [--only attention|motion] [--motion-variants NAME ...]

``--root`` imports the port from another checkout (for example an unpacked
parent commit; ``bench_motion_tail.use_root``), so that two trees can be
timed in turns on one card with this tree's timers: run it with and
without ``--root`` in one call.  Prints the card's name and power limit,
the ``[ptxas]`` lines of the tree's two fp32 sources, then one JSON row per
shape.  Kernel A's bounds: the products' 4·N²·D·H·B FLOP three times on the
tensor cores in TF32 (495 TFLOP/s, ``bound_3xtf32_ms``) and once on the
CUDA cores' fp32 FMA (67 TFLOP/s, ``bound_ffma_ms``); Kernel B's the bytes
(16·B·T·S·C over 3.35 TB/s); Kernel C's its (44·C² + 8·T·C)·B·T·S FLOP the
same two ways (``motion_bounds``), with the weight bytes that its CTAs
read from L2 in a call (``l2_weight_bytes``).

``--motion-variants`` also times Kernel C built from the tree's source
rewritten (``MOTION_DESIGNS``, found by a marker in the source): ``stop1``
to ``stop4`` return after proj_in, the first attention block, the second
and the feed-forward (each writing a few values so that nothing before is
dropped), ``noattn`` skips the frame attention, ``onepass`` issues only
the hi·hi products (a third of the tensor-core work), ``noload`` reads no
weights (the FFMA design: its 16-row stages
are never copied; the Hopper design: the ring is filled once and then read
again without a wait), so that the differences split the kernel's time by
stage and show what the weight stream costs.  Before Kernel C's rows it
prints the SASS mix of each of its kernel functions (``HGMMA``, ``HMMA`` and
``FFMA`` counts from ``cuobjdump -sass``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess

PEAK_TF32 = 495e12  # H100 SXM dense TF32 FLOP/s (data sheet)
PEAK_FP32 = 67e12  # H100 SXM fp32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
QK_STD = 1.6  # chip_smoke.QK_STD: peaked softmax rows
L2_BYTES = 50 * 2**20
# (label, B*T, N, heads, D, fast): chip_smoke.py phase fp32's Kernel A rows
FLASH_SHAPES = (("518x518", 32, 1370, 6, 64, False), ("518x924", 32, 2443, 6, 64, False),
                ("518x518 fast", 32, 1370, 6, 64, True), ("518x924 fast", 32, 2443, 6, 64, True),
                ("synthetic D=192", 32, 1370, 2, 192, False),
                ("synthetic D=192 ragged fast", 32, 2443, 2, 192, True))


# (label, C, S) at B = 1, T = 32: chip_smoke.py phase fp32's Kernel C rows
MOTION_SHAPES = (("vits m3 518x518", 64, 5476), ("vits m0 518x924", 192, 2442),
                 ("vits m2 518x924", 64, 2442), ("vits m3 518x924", 64, 9768),
                 ("vitl m3 518x518", 256, 5476), ("vitl m2 518x924", 256, 2442),
                 ("vitl m3 518x924", 256, 9768), ("vitb m3 518x518", 128, 5476),
                 ("vitb m0 518x924", 384, 2442))
# Source rewrites of csrc/motion_module_f32.cu by design: (marker, {variant:
# ([(old, new), ...], extra nvcc flags)}).
_KEEP = "if (threadIdx.x < C) p.out[(long long)blockIdx.x * C + threadIdx.x] = sy[threadIdx.x];"
MOTION_DESIGNS = (
    ("constexpr int kKC = 16;", {  # the FFMA design: 32-row CTAs, 16-row weight stages
        "noload": ([("for (int i = tid; i < kKC * n4; i += kThreads) {",
                     "for (int i = tid; i < 0; i += kThreads) {")], []),
        **{f"stop{k}": ([(anchor, f"__syncthreads(); {_KEEP} return;\n" + anchor)], [])
           for k, anchor in ((1, "  for (int blk = 0; blk < 2; ++blk) {"),
                             (3, "  // feed-forward: LayerNorm"),
                             (4, "  {  // proj_out, + x"))},
        "stop2": ([("    layer_norm<C>(sy, sh, p.ln_s + blk * C,",
                    f"    if (blk == 1) {{ {_KEEP} return; }}\n"
                    "    layer_norm<C>(sy, sh, p.ln_s + blk * C,")], []),
    }),
    ("MF32_STOP", {  # the Hopper design: the stops and the ring are macros of the source
        **{f"stop{k}": ([], [f"-DMF32_STOP={k}"]) for k in (1, 2, 3, 4)},
        "noload": ([], ["-DMF32_NOLOAD=1"]),
        "noattn": ([], ["-DMF32_NOATTN=1"]),
        "onepass": ([], ["-DMF32_ONEPASS=1"]),
    }),
)


def motion_bounds(b: int, t: int, s: int, c: int) -> tuple:
    """``(3xTF32 ms, FFMA ms)`` of Kernel C's (44·C² + 8·T·C) FLOP a token."""
    flops = b * t * s * (44.0 * c * c + 8.0 * t * c)
    return 3 * flops / PEAK_TF32 * 1e3, flops / PEAK_FP32 * 1e3


def l2_weight_bytes(b: int, t: int, s: int, c: int, weight_bytes: int, rows: int) -> float:
    """Bytes of weights that a call's CTAs read from L2: each CTA of
    ``rows`` rows (whole locations) reads ``weight_bytes`` once."""
    return b * -(-s // (rows // t)) * float(weight_bytes)


def build_motion_variants(names, build_dir) -> dict:
    """``{name: loaded library}`` of Kernel C built from the imported tree's
    source rewritten as ``MOTION_DESIGNS`` says (nvcc in parallel); raises
    where a variant does not apply to the source's design."""
    from video_depth_anything_torch.ops import cuda_build

    src = (cuda_build.CSRC / "motion_module_f32.cu").read_text()
    design = next((v for marker, v in MOTION_DESIGNS if marker in src), None)
    if design is None:
        raise SystemExit("bench_fp32: motion_module_f32.cu is of no known design")
    os.makedirs(build_dir, exist_ok=True)
    procs = {}
    for name in names:
        if name not in design:
            raise SystemExit(f"bench_fp32: no variant {name} of this design")
        rewrites, flags = design[name]
        text = src
        for old, new in rewrites:
            if old not in text:
                raise SystemExit(f"bench_fp32: anchor of {name} not in the source: {old!r}")
            text = text.replace(old, new, 1)
        d = os.path.join(build_dir, name)
        os.makedirs(d, exist_ok=True)
        for f in cuda_build.CSRC.glob("*.cuh"):
            shutil.copy(f, d)
        cu, so = os.path.join(d, "motion_module_f32.cu"), os.path.join(d, "libvariant.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (subprocess.Popen([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *flags,
                                         "-o", so, cu], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"bench_fp32: nvcc failed for {name}:\n{out}")
        for ln in out.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"[ptxas] motion_module_f32 {name}: {ln.strip()}", flush=True)
        fn = ctypes.CDLL(so).vda_motion_module_f32
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes, fn.restype = [vp] * 13 + [i, i, i, i, f, f, vp], ctypes.c_int
        libs[name] = fn
    return libs


def sass_mix(so: str) -> dict:
    """``{kernel function: {opcode: count}}`` of the tensor-core and fp32
    FMA instructions in a library's SASS (``cuobjdump -sass``), each
    opcode with all its modifiers (``HGMMA.64x64x8.F32.TF32``)."""
    import re
    from collections import Counter

    from video_depth_anything_torch.ops import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True, text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), Counter())
            continue
        m = re.search(r"\b(HGMMA\.\S+|HMMA\.\S+|FFMA(?:\.\w+)?)\s", line)
        if m and cur is not None:
            cur[m.group(1).rstrip(",;")] += 1
    return {fn: dict(sorted(c.items())) for fn, c in out.items()}


def flash_bounds(bt: int, n: int, h: int, d: int) -> tuple:
    """``(3xTF32 ms, FFMA ms)`` of Kernel A's products at this shape."""
    flops = 4.0 * bt * h * n * n * d
    return 3 * flops / PEAK_TF32 * 1e3, flops / PEAK_FP32 * 1e3


def temporal_bound(b: int, t: int, s: int, c: int) -> float:
    """Kernel B's bytes bound in ms: q, k, v read and out written, fp32."""
    return 16.0 * b * t * s * c / PEAK_BYTES * 1e3


def _copies(shape, gen, dev, per_call_bytes: float) -> list:
    """fp32 ``(..., 3C)`` inputs as chip_smoke.f32_inputs draws them, as
    many copies as make one pass over them move more than twice the L2."""
    import torch

    out = []
    for _ in range(max(1, -(-2 * L2_BYTES // int(per_call_bytes)))):
        x = torch.randn(*shape[:-1], 3 * shape[-1], generator=gen, device=dev)
        x[..., : 2 * shape[-1]] *= QK_STD
        out.append(x)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None, help="checkout to import the port from")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", choices=("attention", "motion"), default=None,
                    help="time Kernels A and B alone, or Kernel C alone")
    ap.add_argument("--motion-variants", nargs="*", default=[],
                    help="rewritten builds of Kernel C to time beside it (MOTION_DESIGNS)")
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F

    # this tree's timers and loader; then the port from --root, if given
    from video_depth_anything_torch.bench_motion_tail import use_root
    from video_depth_anything_torch.bench_temporal import HEADS, SHAPES, WINDOW_SHAPES
    from video_depth_anything_torch.utils.device import card_line, graph_ms

    if not torch.cuda.is_available():
        raise SystemExit("bench_fp32: no CUDA device")
    if args.root:
        use_root(args.root)
    from video_depth_anything_torch.ops import cuda_build
    from video_depth_anything_torch.ops import flash_attention as fa
    from video_depth_anything_torch.ops import temporal_attention as ta

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    print(card_line(), flush=True)
    print(json.dumps({"root": os.path.dirname(os.path.dirname(os.path.abspath(fa.__file__)))}),
          flush=True)
    cuda_build.build_all()
    for name in ("flash_attention_f32", "temporal_attention_f32", "motion_module_f32"):
        log = cuda_build.BUILD_DIR / f"{name}.log"
        for ln in log.read_text().splitlines() if log.exists() else ():
            if "entry function" in ln or "registers" in ln or "spill" in ln:
                print(f"[ptxas] {name}: {ln.strip()}", flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(14)

    def rel_err(got, want):
        return float((got.float() - want.float()).abs().max() / want.float().abs().max())

    for label, bt, n, h, d, fast in FLASH_SHAPES if args.only != "motion" else ():
        copies = [tuple(t.view(bt, n, h, d) for t in x.split(h * d, dim=-1))
                  for x in _copies((bt, n, h * d), g, dev, 16.0 * bt * n * h * d)]
        scale = d**-0.5
        q, k, v = copies[0]
        got = fa.flash_attention(q, k, v, scale, fast=fast)
        want = fa.flash_attention_plain(q, k, v, scale, fast=fast)
        ms = graph_ms([lambda x=x: fa.flash_attention(*x, scale, fast=fast) for x in copies],
                      args.iters)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = graph_ms([lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale)],
                       args.iters)
        b3, bf = flash_bounds(bt, n, h, d)
        print(json.dumps({
            "kernel": "flash_attention_f32", "shape": f"{label} (B*T={bt}, N={n}, H={h}, D={d})",
            "ms": ms, "library_ms": lib, "bound_3xtf32_ms": b3, "bound_ffma_ms": bf,
            "ms_over_3xtf32": ms / b3, "ms_over_library": ms / lib,
            "rel_err": rel_err(got, want)}), flush=True)
        del copies, q, k, v, qt, kt, vt, got, want
        torch.cuda.empty_cache()

    for label, b, t, s, c in SHAPES + WINDOW_SHAPES if args.only != "motion" else ():
        copies = [tuple(y.contiguous() for y in x.split(c, dim=-1))
                  for x in _copies((b, t, s, c), g, dev, 16.0 * b * t * s * c)]
        d = c // HEADS
        scale = d**-0.5
        q, k, v = copies[0]
        got = ta.temporal_attention(q, k, v, HEADS, scale)
        want = ta.temporal_attention_plain(q, k, v, HEADS, scale)
        ms = graph_ms([lambda x=x: ta.temporal_attention(*x, HEADS, scale) for x in copies],
                      args.iters)
        q5, k5, v5 = (x.view(b, t, s, HEADS, d).permute(0, 2, 3, 1, 4) for x in (q, k, v))
        lib = graph_ms([lambda: F.scaled_dot_product_attention(q5, k5, v5, scale=scale)],
                       args.iters)
        bound = temporal_bound(b, t, s, c)
        print(json.dumps({
            "kernel": "temporal_attention_f32", "shape": f"{label} (B={b}, T={t}, S={s}, C={c})",
            "d": d, "ms": ms, "library_ms": lib, "bound_ms": bound, "bound_by": "bytes",
            "ms_over_bound": ms / bound, "ms_over_library": ms / lib,
            "rel_err": rel_err(got, want)}), flush=True)
        del copies, q, k, v, q5, k5, v5, got, want
        torch.cuda.empty_cache()
    if args.only != "attention":
        bench_motion(args, dev, g, rel_err)
    return 0


def bench_motion(args, dev, g, rel_err) -> None:
    """Kernel C's rows (``MOTION_SHAPES``), and its rewritten builds."""
    import torch

    from video_depth_anything_torch.config import MotionModuleConfig
    from video_depth_anything_torch.ops import cuda_build
    from video_depth_anything_torch.ops import motion_module as mm
    from video_depth_anything_torch.utils.device import graph_ms

    for fn, mix in sass_mix(str(cuda_build.library("motion_module_f32")._name)).items():
        print(json.dumps({"sass": "motion_module_f32", "function": fn, **mix}), flush=True)
    variants = build_motion_variants(args.motion_variants,
                                     os.path.join(cuda_build.BUILD_DIR, "motion_variants"))
    cfg = MotionModuleConfig()
    rows = getattr(mm, "F32_ROWS", 32)  # rows a CTA: the FFMA design's 32 where not given
    for label, c, s in MOTION_SHAPES:
        b, t = 1, 32
        gen = torch.Generator().manual_seed(c)
        p = {k: v.to(dev) for k, v in _motion_params(c, gen).items()}
        w = mm.kernel_weights(p, cfg, torch.float32)
        copies = []
        for _ in range(max(1, -(-2 * L2_BYTES // int(8 * b * t * s * c)))):
            x = torch.randn(b, t, s, c, device=dev, generator=g)
            copies.append((x, *mm.gn_fold(x, w, cfg)))
        x, gna, gnb = copies[0]
        got = mm.motion_module_launch(x, gna, gnb, w, cfg, 8)
        want = mm.motion_module_plain(x, p, cfg, 8)
        err = float((got - want).abs().max() / (want - x).abs().max())
        ms = graph_ms([lambda a=a: mm.motion_module_launch(*a, w, cfg, 8) for a in copies],
                      args.iters)
        b3, bf = motion_bounds(b, t, s, c)
        row = {"kernel": "motion_module_f32", "shape": f"{label} (B={b}, T={t}, S={s}, C={c})",
               "ms": ms, "bound_3xtf32_ms": b3, "bound_ffma_ms": bf, "ms_over_3xtf32": ms / b3,
               "ms_over_ffma": ms / bf, "rel_err": err,
               "l2_weight_gb": l2_weight_bytes(b, t, s, c, w["w"].numel() * 4, rows) / 1e9}
        for name, fn in variants.items():
            def call(a, fn=fn):
                out, _x, cargs = mm._launch_args(*a, w, cfg, 8)
                cuda_build.check(fn(*cargs), f"motion_module_f32 {name}")
                return out
            row[f"{name}_ms"] = graph_ms([lambda a=a: call(a) for a in copies], args.iters)
        print(json.dumps(row), flush=True)
        del copies, x, gna, gnb, got, want, w, p
        torch.cuda.empty_cache()


def _motion_params(c: int, gen) -> dict:
    """Seeded raw motion-module parameters (JAX layout), as
    ``chip_smoke.motion_params`` draws them."""
    import torch

    n = lambda *s, std=1.0: torch.randn(*s, generator=gen) * std  # noqa: E731
    return dict(gn_scale=1 + n(c, std=0.1), gn_bias=n(c, std=0.1), w_in=n(c, c, std=c**-0.5),
                b_in=n(c, std=0.1), ln_scale=1 + n(3, c, std=0.1), ln_bias=n(3, c, std=0.1),
                wq=n(2, c, c, std=c**-0.5), wk=n(2, c, c, std=c**-0.5), wv=n(2, c, c, std=c**-0.5),
                wo=n(2, c, c, std=c**-0.5), bo=n(2, c, std=0.1), w1=n(c, 8 * c, std=c**-0.5),
                b1=n(8 * c, std=0.1), w2=n(4 * c, c, std=(4 * c) ** -0.5), b2=n(c, std=0.1),
                w_out=n(c, c, std=c**-0.5), b_out=n(c, std=0.1))


if __name__ == "__main__":
    raise SystemExit(main())
