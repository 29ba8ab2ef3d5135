"""Kernel C and the output-tail kernel on the card, alone: ms per launch and
the split by stage, at the main path's shapes.

    python -m video_depth_anything_torch.bench_motion_tail [--root DIR] [--iters N]
    python -m video_depth_anything_torch.bench_motion_tail --wide [--root DIR] [--domain]

``--root`` imports ``video_depth_anything_torch`` from another checkout
(for example an unpacked parent commit), so that two trees can be timed in
turns on one card; a tree without the split entry points prints ms only.
Prints the card's name and power limit, then one JSON row per shape:
Kernel C at the nine shapes of ``chip_smoke.py`` phase kernels (C = 64,
128, 192, 256 and 384, 32 frames) and two of its wide chain's (vitb m1 and
vitl m0 at 518², C = 768 and 1024), on seeded noised weights, with the
GroupNorm fold done before (``ms`` times the launch alone) and the split at
the first shape of each width that has one; then the tail at vitl 518² and
518×924 (C = 128) and, where the tree's kernel takes them, at vits' and vitb's
widths, C = 32 and 64, on their 518² maps (``packed_output_stack=False``).

``--wide`` times Kernel C's wide chain (``csrc/motion_module_wide.cu``)
instead, at its six shipped shapes (``WIDE_SHAPES``: vitb m1, vitl m0 and m1
of a 32-frame window at 518² and 518×924), bf16 then fp32: the whole chain
(``ms``), its time by launch (``split_ms``: CUDA events between the
launches, the entry ``vda_motion_module_wide_split``) in full and in the
split builds (``WIDE_VARIANTS``: the loads dropped, the epilogues dropped,
the TMA stores of the epilogues dropped), and ``torch.matmul``'s time for each product's shape on
operands of the chain's dtype (``library_ms``, TF32 off in fp32; the port
never calls it).  A tree whose source has no split entry (an earlier chain) is
rewritten to have one (``PARENT_REWRITES``), as ``bench_probe_split`` does.
``--domain`` adds phase ``domain``'s chain configs (``chip_smoke.
domain_c_shapes``), whole-chain ms in both dtypes.  Run two trees in turns as
separate invocations in one command (parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import sys

# this tree's launch names, also for a --root checkout (the chain's plan has not changed)
from video_depth_anything_torch.ops.motion_module import wide_launch_names

# chip_smoke.py phase kernels' shapes; the split runs at the first of each width
MOTION_SHAPES = (("m3 518x518", 64, 5476), ("m0 518x924", 192, 2442),
                 ("m2 518x924", 64, 2442), ("m3 518x924", 64, 9768),
                 ("vitl m3 518x518", 256, 5476), ("vitl m2 518x924", 256, 2442),
                 ("vitl m3 518x924", 256, 9768), ("vitb m3 518x518", 128, 5476),
                 ("vitb m0 518x924", 384, 2442), ("vitb m1 518x518", 768, 361),
                 ("vitl m0 518x518", 1024, 1369))
TAIL_SHAPES = (("vitl 518x518", 128, (32, 296, 296, 518, 518)),
               ("vitl 518x924", 128, (32, 296, 528, 518, 924)),
               ("vits 518x518 unpacked", 32, (32, 296, 296, 518, 518)),
               ("vitb 518x518 unpacked", 64, (32, 296, 296, 518, 518)))


def use_root(root: str) -> None:
    """Import ``video_depth_anything_torch`` from the checkout ``root`` from
    now on (functions imported before keep this tree's code)."""
    sys.path.insert(0, os.path.abspath(root))
    for name in [m for m in sys.modules if m.startswith("video_depth_anything_torch")]:
        del sys.modules[name]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None, help="checkout to import the port from")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--wide", action="store_true", help="time Kernel C's wide chain instead")
    ap.add_argument("--domain", action="store_true",
                    help="with --wide: also phase domain's chain configs")
    args = ap.parse_args(argv)
    if args.domain and not args.wide:
        ap.error("--domain needs --wide")
    return args


# -- the wide chain (--wide) ---------------------------------------------------

# (label, C, S) of one 32-frame window at 8 heads, two attention blocks and
# ff_mult 4: chip_smoke.WIDE_MOTION_ROWS
WIDE_SHAPES = (("vitb m1 518x518", 768, 361), ("vitb m1 518x924", 768, 627),
               ("vitl m0 518x518", 1024, 1369), ("vitl m0 518x924", 1024, 2442),
               ("vitl m1 518x518", 1024, 361), ("vitl m1 518x924", 1024, 627))
WIDE_VARIANTS = ("full", "noloads", "noepilogue", "nostore")
# the current source's WIDE_SPLIT of each split build
SPLIT_FLAG = {"full": 0, "noloads": 2, "noepilogue": 3, "nostore": 4}
# The split entry of the current source: extern "C" int
# vda_motion_module_wide_split(<the chain's arguments>, int f32, int iters,
# float* ms): ms[i] the mean ms of launch i, -1 past the last.
SPLIT_ENTRY = "vda_motion_module_wide_split"
SPLIT_SLOTS = 64
# An earlier source (no split entry) rewritten: CUDA events between its launches and the
# split entry appended (every variant), then each variant's change of its GEMM
# (anchor, replacement).  ``wide_source`` raises where an anchor is missing.
_PARENT_MARKS = (
    ("#define VDA_WIDE_CHECK(call) \\\n  if ((e = (call)) != 0) return e;",
     "wide_mark(st);\n#define VDA_WIDE_CHECK(call) \\\n  if ((e = (call)) != 0) return e; \\\n"
     "  wide_mark(st);"),
)
_PARENT_HEAD = """#include <cuda_runtime.h>
static cudaEvent_t wide_ev[SPLIT_SLOTS + 1];
static int wide_nev = -1;  // -1: no marks
static void wide_mark(cudaStream_t st) {
  if (wide_nev >= 0 && wide_nev <= SPLIT_SLOTS) cudaEventRecord(wide_ev[wide_nev++], st);
}
""".replace("SPLIT_SLOTS", str(SPLIT_SLOTS))
_PARENT_TAIL = """
extern "C" int vda_motion_module_wide_split(VDA_WIDE_ARGS, int f32, int iters, float* ms) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (auto& e : wide_ev)
    if (e == nullptr && cudaEventCreate(&e) != cudaSuccess) return 1;
  for (int i = 0; i < SPLIT_SLOTS; ++i) ms[i] = 0.f;
  int n = 0;
  for (int it = 0; it <= iters; ++it) {  // the first run warms up
    wide_nev = 0;
    const int e = f32 ? dispatch<float>(VDA_WIDE_STRUCT, st) : dispatch<bf16>(VDA_WIDE_STRUCT, st);
    n = wide_nev - 1;
    wide_nev = -1;
    if (e) return e;
    if (cudaEventSynchronize(wide_ev[n]) != cudaSuccess) return 1;
    for (int i = 0; it > 0 && i < n; ++i) {
      float t = 0.f;
      cudaEventElapsedTime(&t, wide_ev[i], wide_ev[i + 1]);
      ms[i] += t / iters;
    }
  }
  for (int i = n; i < SPLIT_SLOTS; ++i) ms[i] = -1.f;
  return 0;
}
""".replace("SPLIT_SLOTS", str(SPLIT_SLOTS))
PARENT_REWRITES = {
    "full": (),
    "noloads": (  # the producer arrives without copying: stale stages
        ("        mbar_arrive_expect_tx(&full[s], STAGE);\n"
         "        tma_load_3d(base + s * STAGE, &amap, &full[s], kp * KW, m0, 0);\n"
         "        bulk_load(base + s * STAGE + A_BYTES, wsrc + (long long)kp * B_BYTES, B_BYTES, "
         "&full[s]);", "        mbar_arrive(&full[s]);"),),
    "noepilogue": (("  fence_regs(acc);\n", "  fence_regs(acc);\n  if (g.M > 0) return;\n"),),
}


def wide_product_shapes(m: int, c: int, hidden: int, n_attn: int = 2) -> dict:
    """``{launch: (M, K, N)}`` of the chain's products (GEGLU: N = 2F)."""
    out = {"proj_in": (m, c, c)}
    for i in range(1, n_attn + 1):
        out[f"qkv{i}"], out[f"out{i}"] = (m, c, 3 * c), (m, c, c)
    out.update(geglu=(m, c, 2 * hidden), w2=(m, hidden, c), proj_out=(m, c, c))
    return out


def wide_variants(text: str) -> tuple:
    """The split builds of a source: ``WIDE_VARIANTS`` for the current one,
    ``PARENT_REWRITES``' for an earlier one."""
    return WIDE_VARIANTS if SPLIT_ENTRY in text else tuple(PARENT_REWRITES)


def wide_source(text: str, variant: str) -> tuple:
    """``(source, extra nvcc flags)`` of a split build of the wide chain: the
    current source as it is with ``-DWIDE_SPLIT=SPLIT_FLAG[variant]``; an
    earlier one (no split entry) rewritten by ``PARENT_REWRITES``."""
    if SPLIT_ENTRY in text:
        return text, [f"-DWIDE_SPLIT={SPLIT_FLAG[variant]}"]
    for anchor, new in _PARENT_MARKS + PARENT_REWRITES[variant]:
        if anchor not in text:
            raise ValueError(f"wide_source: the {variant} rewrite's anchor is missing: {anchor!r}")
        text = text.replace(anchor, new)
    return _PARENT_HEAD + text + _PARENT_TAIL, []


def build_wide_variants(csrc: str, out_dir: str) -> dict:
    """Compile the split builds of ``csrc``'s wide chain, all at once, into
    ``out_dir/<hash>``: ``{variant: (library path, ptxas lines)}``."""
    from video_depth_anything_torch.ops import cuda_build

    with open(os.path.join(csrc, "motion_module_wide.cu")) as f:
        text = f.read()
    procs = {}
    for v in wide_variants(text):
        src, flags = wide_source(text, v)
        key = hashlib.sha256((src + " ".join(flags)).encode())
        for h in sorted(os.listdir(csrc)):
            if h.endswith(".cuh"):
                key.update(open(os.path.join(csrc, h), "rb").read())
        d = os.path.join(out_dir, f"wide_{v}_{key.hexdigest()[:12]}")
        so = os.path.join(d, "libwide.so")
        if os.path.exists(so):
            procs[v] = (None, so)
            continue
        os.makedirs(d, exist_ok=True)
        for h in os.listdir(csrc):
            if h.endswith(".cuh"):
                shutil.copy(os.path.join(csrc, h), d)
        with open(os.path.join(d, "wide.cu"), "w") as f:
            f.write(src)
        procs[v] = (subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *flags, "-o", so + ".tmp",
             os.path.join(d, "wide.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), so)
    out = {}
    for v, (proc, so) in procs.items():
        lines = []
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"bench_motion_tail: nvcc failed for the {v} build:\n{log}")
            os.replace(so + ".tmp", so)
            lines = [ln.strip() for ln in log.splitlines()
                     if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        out[v] = (so, lines)
    return out


def wide_split(lib, mm, x, gna, gnb, w, cfg, heads: int, iters: int) -> list:
    """ms of each of the chain's launches (CUDA events between them, the
    mean of ``iters`` runs after one warm run) from a split build's library;
    not counted as launches."""
    import torch

    fn = lib.vda_motion_module_wide_split
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [vp] * 13 + [i, i, i, i, f, f, vp] + [vp, i, i, i] + [i, i, vp]
    fn.restype = ctypes.c_int
    out, _x, args = mm._launch_args(x, gna, gnb, w, cfg, heads)
    c, hidden = x.shape[-1], w["b1"].numel() // 2
    scratch = torch.empty(mm.wide_scratch_elems(x.numel() // c, c, hidden), dtype=x.dtype,
                          device=x.device)
    ms = (ctypes.c_float * SPLIT_SLOTS)()
    err = fn(*args, ctypes.c_void_p(scratch.data_ptr()), heads, cfg.num_attention_blocks, hidden,
             int(x.dtype == torch.float32), iters, ms)
    if err:
        raise RuntimeError(f"vda_motion_module_wide_split: CUDA error {err}")
    torch.cuda.synchronize()
    return [ms[k] for k in range(SPLIT_SLOTS) if ms[k] >= 0]


def wide_bound_ms(m: int, c: int, n_attn: int = 2, ff: int = 4, t: int = 32,
                  f32: bool = False) -> float:
    """The chain's tensor-core bound: (4 + 8 n_attn + 6 ff) C² + 4 n_attn T C
    FLOPs a token (44 C² + 8 T C at two blocks and ff_mult 4) at 989 TFLOP/s
    in bf16, three times the FLOPs at 495 in 3xTF32 (chip_smoke.py's Kernel C
    bound)."""
    flops = m * ((4 + 8 * n_attn + 6 * ff) * c * c + 4 * n_attn * t * c)
    return 3 * flops / 495e12 * 1e3 if f32 else flops / 989e12 * 1e3


def wide_row(label: str, dtype: str, c: int, s: int, ms: float, splits: dict, library: dict,
             hidden: int, n_attn: int = 2) -> dict:
    """One JSON row of ``--wide``: the whole chain, its launches by variant,
    the library's product times and their sum beside the chain's."""
    names = wide_launch_names(n_attn)
    m = 32 * s
    row = {"kernel": "motion_module_wide" + ("_f32" if dtype == "fp32" else ""),
           "shape": f"{label} (1x32x{s}x{c})", "dtype": dtype, "ms": ms,
           "bound_ms": wide_bound_ms(m, c, n_attn, f32=dtype == "fp32")}
    row["ms/bound_ms"] = ms / row["bound_ms"]
    for variant, vals in splits.items():
        key = "split_ms" if variant == "full" else f"split_ms_{variant}"
        row[key] = dict(zip(names, vals)) if len(vals) == len(names) else vals
        if variant == "full":
            row["split_sum_ms"] = sum(vals)
    row["library_ms"] = library
    row["library_sum_ms"] = sum(library.values())
    full = row.get("split_ms", {})
    if isinstance(full, dict):
        row["products_ms"] = sum(full[k] for k in library if k in full)
        row["products/library"] = row["products_ms"] / row["library_sum_ms"]
    return row


def wide_main(args) -> int:
    import torch

    import chip_smoke  # the seeded module parameters and phase domain's configs
    from video_depth_anything_torch.config import MotionModuleConfig
    from video_depth_anything_torch.ops import motion_module as mm
    from video_depth_anything_torch.utils.device import card_line, event_ms

    if not torch.cuda.is_available():
        print("bench_motion_tail: no CUDA device", flush=True)
        return 3
    print(card_line(), flush=True)
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(mm.__file__)))
    print(json.dumps({"root": pkg}), flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    builds = build_wide_variants(os.path.join(pkg, "csrc"), os.path.join(here, "_build", "wide_split"))
    for v, (so, lines) in builds.items():
        print(json.dumps({"build": v, "ptxas": lines}), flush=True)
    libs = {v: ctypes.CDLL(so) for v, (so, _) in builds.items()}
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    cfg = MotionModuleConfig()
    for dtype in (torch.bfloat16, torch.float32):
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        for label, c, s in WIDE_SHAPES:
            p = chip_smoke.domain_motion_params(c, 2, 4, c + s, dev)
            x = torch.randn(1, 32, s, c, generator=gen).to(dev, dtype)
            w = mm.kernel_weights(p, cfg, dtype)
            gna, gnb = mm.gn_fold(x, w, cfg)
            ms = event_ms(lambda: mm.motion_module_launch(x, gna, gnb, w, cfg, 8), iters=args.iters)
            splits = {}
            for v, lib in libs.items():
                try:
                    splits[v] = wide_split(lib, mm, x, gna, gnb, w, cfg, 8, args.iters)
                except RuntimeError as e:
                    raise RuntimeError(f"{label} {name}, the {v} build: {e}") from None
            hidden = w["b1"].numel() // 2
            library = {}
            for k, (m, kk, n) in wide_product_shapes(32 * s, c, hidden).items():
                a = torch.randn(m, kk, generator=gen).to(dev, dtype)
                b = (torch.randn(kk, n, generator=gen) * kk**-0.5).to(dev, dtype)
                library[k] = event_ms(lambda: torch.matmul(a, b), iters=args.iters)
                del a, b
            print(json.dumps(wide_row(label, name, c, s, ms, splits, library, hidden)), flush=True)
            del p, x, w, gna, gnb
            torch.cuda.empty_cache()
    if args.domain:
        for dtype in (torch.bfloat16, torch.float32):
            for c, heads, blocks, ff in chip_smoke.domain_c_shapes():
                s = chip_smoke.DOMAIN_S if c < 640 else chip_smoke.DOMAIN_S_WIDE
                mcfg = MotionModuleConfig(num_heads=heads, num_attention_blocks=blocks, ff_mult=ff,
                                          norm_num_groups=__import__("math").gcd(32, c))
                if mm.resident(c, heads, mcfg):
                    continue
                p = chip_smoke.domain_motion_params(c, blocks, ff, c * 7 + heads + blocks + ff, dev)
                x = torch.randn(1, 32, s, c, generator=gen).to(dev, dtype)
                w = mm.kernel_weights(p, mcfg, dtype)
                gna, gnb = mm.gn_fold(x, w, mcfg)
                ms = event_ms(lambda: mm.motion_module_launch(x, gna, gnb, w, mcfg, heads),
                              iters=5, warmup=1)
                print(json.dumps({"kernel": "motion_module_wide" + ("_f32" if dtype == torch.float32
                                                                    else ""),
                                  "domain": [c, heads, blocks, ff], "S": s, "ms": ms}), flush=True)
                del p, x, w, gna, gnb
            torch.cuda.empty_cache()
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.root:
        use_root(args.root)
    if args.wide:
        return wide_main(args)
    import torch

    from video_depth_anything_torch.config import MotionModuleConfig
    from video_depth_anything_torch.ops import motion_module as mm
    from video_depth_anything_torch.ops import output_tail as ot
    from video_depth_anything_torch.utils.device import card_line, event_ms

    if not torch.cuda.is_available():
        print("bench_motion_tail: no CUDA device", flush=True)
        return 3
    print(card_line(), flush=True)
    print(json.dumps({"root": os.path.dirname(os.path.dirname(os.path.abspath(mm.__file__)))}))
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    rnd = lambda *s, std=1.0: (torch.randn(*s, generator=gen) * std).to(dev)  # noqa: E731
    cfg = MotionModuleConfig()
    split_done = set()
    for label, c, s in MOTION_SHAPES:
        p = dict(gn_scale=1 + rnd(c, std=0.1), gn_bias=rnd(c, std=0.1),
                 w_in=rnd(c, c, std=c**-0.5), b_in=rnd(c, std=0.1),
                 ln_scale=1 + rnd(3, c, std=0.1), ln_bias=rnd(3, c, std=0.1),
                 wq=rnd(2, c, c, std=c**-0.5), wk=rnd(2, c, c, std=c**-0.5),
                 wv=rnd(2, c, c, std=c**-0.5), wo=rnd(2, c, c, std=c**-0.5), bo=rnd(2, c, std=0.1),
                 w1=rnd(c, 8 * c, std=c**-0.5), b1=rnd(8 * c, std=0.1),
                 w2=rnd(4 * c, c, std=(4 * c) ** -0.5), b2=rnd(c, std=0.1),
                 w_out=rnd(c, c, std=c**-0.5), b_out=rnd(c, std=0.1))
        x = rnd(1, 32, s, c).to(torch.bfloat16)
        w = mm.kernel_weights(p, cfg)
        gna, gnb = mm.gn_fold(x, w, cfg)
        row = {"kernel": "motion_module", "shape": f"{label} (1x32x{s}x{c})",
               "ms": event_ms(lambda: mm.motion_module_launch(x, gna, gnb, w, cfg, 8),
                              iters=args.iters)}
        if hasattr(mm, "motion_module_split") and c in mm.SPLIT_C and c not in split_done:
            split_done.add(c)
            row["split_ms"] = mm.motion_module_split(x, gna, gnb, w, cfg, 8, iters=args.iters)
        print(json.dumps(row), flush=True)
        del x, w, gna, gnb
    for label, c, (n, h, wd, oh, ow) in TAIL_SHAPES:
        if c not in ot._SUPPORTED_C:  # an earlier tree's kernel: C = 128 only
            continue
        x = rnd(n, h, wd, c).to(torch.bfloat16)
        w1, b1, w2, b2 = rnd(32, c, 3, 3, std=0.1), rnd(32, std=0.1), rnd(1, 32, 1, 1, std=0.3), \
            rnd(1, std=0.1)
        row = {"kernel": "output_tail", "shape": f"{label} ({n}x{h}x{wd}x{c} -> {oh}x{ow})",
               "ms": event_ms(lambda: ot.output_tail(x, w1, b1, w2, b2, oh, ow), iters=args.iters)}
        if hasattr(ot, "output_tail_split"):
            row["split_ms"] = ot.output_tail_split(x, w1, b1, w2, b2, oh, ow, iters=args.iters)
        print(json.dumps(row), flush=True)
        del x
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
