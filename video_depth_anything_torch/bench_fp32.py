"""The fp32 Kernels A and B on the card, alone, at ``chip_smoke.py`` phase
fp32's shapes: Kernel A at vits 32×1370 and 32×2443 (6 heads of 64, exact
and fast) and at D = 192 (2 heads, exact at 1370 and fast at 2443), Kernel
B at ``bench_temporal``'s shapes (its rows, then the window calls at the
pipeline's batch of 4).  Device ms per launch (``graph_ms``, inputs
rotated through more bytes than L2 holds) beside the bounds, SDPA's ms in
fp32 (TF32 off: the yardstick) and the error against the plain version.

    python -m video_depth_anything_torch.bench_fp32 [--root DIR] [--iters N]

``--root`` imports the port from another checkout (for example an unpacked
parent commit; ``bench_motion_tail.use_root``), so that two trees can be
timed in turns on one card with this tree's timers: run it with and
without ``--root`` in one call.  Prints the card's name and power limit,
the ``[ptxas]`` lines of the tree's two fp32 sources, then one JSON row per
shape.  Kernel A's bounds: the products' 4·N²·D·H·B FLOP three times on the
tensor cores in TF32 (495 TFLOP/s, ``bound_3xtf32_ms``) and once on the
CUDA cores' fp32 FMA (67 TFLOP/s, ``bound_ffma_ms``); Kernel B's the bytes
(16·B·T·S·C over 3.35 TB/s).
"""

from __future__ import annotations

import argparse
import json
import os

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
    for name in ("flash_attention_f32", "temporal_attention_f32"):
        log = cuda_build.BUILD_DIR / f"{name}.log"
        for ln in log.read_text().splitlines() if log.exists() else ():
            if "entry function" in ln or "registers" in ln or "spill" in ln:
                print(f"[ptxas] {name}: {ln.strip()}", flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(14)

    def rel_err(got, want):
        return float((got.float() - want.float()).abs().max() / want.float().abs().max())

    for label, bt, n, h, d, fast in FLASH_SHAPES:
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

    for label, b, t, s, c in SHAPES + WINDOW_SHAPES:
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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
