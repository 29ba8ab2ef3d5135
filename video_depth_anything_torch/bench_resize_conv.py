"""Where the fused resize → conv (``ops/resize_conv.py``) spends its time on
the card, at the vitl junction (32×148×148×256 → 296²×128).

    python -m video_depth_anything_torch.bench_resize_conv [ROOT ...] [--iters N]

For each checkout ROOT (default: this tree; for example an unpacked parent
commit and this tree, to time the two in turns on one card) it builds that
checkout's ``csrc/resize_conv.cu`` four times, each rewritten at fixed
anchors behind an ``RC_STOP`` macro (at 0 the source is the kernel as
shipped):

* ``full``: the kernel;
* ``nogemm`` (``RC_STOP=1``): the conv's products skipped, the epilogue
  storing the bias: the resize, the weights' traffic where it is not
  inside the products, and the stores;
* ``noresize`` (``RC_STOP=2``): the resized tile never built (its shared
  memory holds whatever it held): the conv and the stores;
* ``neither`` (``RC_STOP=3``): both skipped: what is left is the weights'
  traffic (the ``mma.sync`` kernel's only in its products, so none), the
  hand-overs and the stores.

It imports the checkout's ``ops/resize_conv`` (its ``full`` build in place
of the library its ``cuda_build`` would build) and times in turns, per
checkout in order and then reversed: each build's launch alone on
arguments prepared once (``kernel_ms``, ``nogemm_ms``, ``noresize_ms``,
``neither_ms``),
the checkout's wrapper ``resize_conv`` whole (``wrapper_ms``: the weight
layout, the tap tables and the launch), and their difference, the wrapper's
own time.  Times are CUDA events around ``--iters`` calls
(``utils/device.event_ms``).  The ``full`` build and the wrapper are held
against this tree's ``resize_conv_plain``.  The designs are found from the
sources (``DESIGNS``): the ``mma.sync`` ``resize_conv_kernel`` (in
checkouts that still hold it) and ``resize_conv_hopper``.  Prints the card's
name and power limit, the ``ptxas`` lines of each build, then one JSON row
per checkout and build.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile

JUNCTION = (32, 148, 148, 256, 296, 296)  # N, H, W, C, out_h, out_w

MMA_SYNC = {  # the mma.sync kernel before the Hopper one: B from L2 in fragment order
    "name": "mma", "marker": "resize_conv_kernel",
    "rewrites": [
        ("    for (int i = tid; i < HH * HW * (CC / 8); i += NTHREADS) {\n",
         "    for (int i = RC_STOP & 2 ? HH * HW * (CC / 8) : tid; i < HH * HW * (CC / 8);"
         " i += NTHREADS) {\n"),
        ("#pragma unroll 1\n    for (int tap = 0; tap < 9; ++tap) {\n",
         "#pragma unroll 1\n    for (int tap = 0; tap < (RC_STOP & 1 ? 0 : 9); ++tap) {\n"),
    ],
}
HOPPER = {  # resize_conv_hopper: the stops are in the source
    "name": "hopper", "marker": "resize_conv_hopper", "rewrites": [],
}
DESIGNS = (HOPPER, MMA_SYNC)  # the new marker first: the new source names the TPU kernel
BUILDS = {"full": [], "nogemm": ["-DRC_STOP=1"], "noresize": ["-DRC_STOP=2"],
          "neither": ["-DRC_STOP=3"]}


def design_of(csrc: str) -> dict:
    text = open(os.path.join(csrc, "resize_conv.cu")).read()
    for design in DESIGNS:
        if design["marker"] in text:
            return design
    raise SystemExit(f"bench_resize_conv: no resize -> conv kernel of a known design in {csrc}")


def start_build(csrc: str, design: dict, flags: list, out_dir: str):
    """Compile the rewritten source with ``flags``: ``(process, library)``."""
    from video_depth_anything_torch.ops import cuda_build

    os.makedirs(out_dir, exist_ok=True)
    for f in os.listdir(csrc):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(csrc, f), out_dir)
    text = open(os.path.join(csrc, "resize_conv.cu")).read()
    for anchor, new in design["rewrites"]:
        if text.count(anchor) != 1:
            raise SystemExit(f"bench_resize_conv: anchor not found once: {anchor[:60]!r}")
        text = text.replace(anchor, new)
    cu, so = os.path.join(out_dir, "rc.cu"), os.path.join(out_dir, "librc.so")
    with open(cu, "w") as f:
        f.write("#ifndef RC_STOP\n#define RC_STOP 0\n#endif\n" + text)
    proc = subprocess.Popen([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *flags, "-o", so, cu],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, so


def import_port(root: str):
    """The checkout's ``ops/resize_conv`` module: this process's
    ``video_depth_anything_torch`` modules are dropped first, and the
    checkout's stay alive through the returned module."""
    for name in [m for m in sys.modules if m.startswith("video_depth_anything_torch")]:
        del sys.modules[name]
    sys.path.insert(0, root)
    try:
        return importlib.import_module("video_depth_anything_torch.ops.resize_conv")
    finally:
        sys.path.remove(root)


def launch_args(design: dict, rc, x, w, b, out_h: int, out_w: int):
    """``(argtypes, args, keep)`` of the checkout's ``vda_resize_conv`` on
    these inputs, prepared as its wrapper prepares them."""
    from video_depth_anything_torch.ops import cuda_build

    vp, i = ctypes.c_void_p, ctypes.c_int
    n, h, wd, c = x.shape
    if design is MMA_SYNC:  # x, yi, yw, xi, xw, w (fragment order), bias, out, 6 ints, stream
        import torch

        wf = rc._frag(w.permute(2, 3, 1, 0).reshape(9 * c, 128))
        bias = b.reshape(-1).to(torch.bfloat16).float()
        yi, yw = rc._taps(h, out_h, x.device)
        xi, xw = rc._taps(wd, out_w, x.device)
        out = torch.empty((n, out_h, out_w, 128), dtype=x.dtype, device=x.device)
        keep = (x, yi, yw, xi, xw, wf, bias, out)
        args = (*(cuda_build.ptr(t) for t in keep), n, h, wd, c, out_h, out_w,
                cuda_build.stream_of(x))
        return [vp] * 8 + [i] * 6 + [vp], args, keep
    out, keep, args = rc._launch_args(x, w, b, out_h, out_w)
    return rc.ARGTYPES, args, (out, keep)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", help="checkouts whose kernels to time (default: this one)")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    import torch

    from video_depth_anything_torch.ops.resize_conv import resize_conv_plain
    from video_depth_anything_torch.utils.device import card_line, event_ms

    if not torch.cuda.is_available():
        print("bench_resize_conv: no CUDA device", flush=True)
        return 3
    print(card_line(), flush=True)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    roots = [os.path.abspath(r) for r in args.roots or [here]]
    out_dir = tempfile.mkdtemp(prefix="resize_conv_split_")
    started = {}
    for t, root in enumerate(roots):
        csrc = os.path.join(root, "video_depth_anything_torch", "csrc")
        design = design_of(csrc)
        for name, flags in BUILDS.items():
            started[(t, name)] = (design, *start_build(csrc, design, flags,
                                                       os.path.join(out_dir, f"{t}_{name}")))
    libs = {}
    for (t, name), (design, proc, so) in started.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"bench_resize_conv: nvcc failed for {roots[t]} {name}:\n{out}")
        for ln in out.splitlines():
            if "entry function" in ln or "registers" in ln or "spill" in ln or "wgmma" in ln:
                print(f"[ptxas] {os.path.basename(roots[t])}:{name}: {ln.strip()}", flush=True)
        libs[(t, name)] = ctypes.CDLL(so)

    dev = torch.device("cuda")
    n, h, w, c, oh, ow = JUNCTION
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(n, h, w, c, generator=g, device=dev).to(torch.bfloat16)
    wc = torch.randn(128, c, 3, 3, generator=g, device=dev) * 0.1
    bc = torch.randn(128, generator=g, device=dev) * 0.1
    want = resize_conv_plain(x, wc, bc, oh, ow).float()
    scale = float(want.abs().max())
    trees = []
    for t, root in enumerate(roots):
        design = started[(t, "full")][0]
        rc = import_port(root)
        rc.cuda_build._libs["resize_conv"] = libs[(t, "full")]
        argtypes, launch, keep = launch_args(design, rc, x, wc, bc, oh, ow)
        fns = {}
        for name in BUILDS:
            fn = libs[(t, name)].vda_resize_conv
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            fns[name] = fn
        trees.append((root, design, rc, fns, launch, keep))

    def call(fn, launch):
        err = fn(*launch)
        if err:
            raise RuntimeError(f"bench_resize_conv: CUDA error {err} at launch")

    times = {(t, k): [] for t in range(len(trees)) for k in ("wrapper", *BUILDS)}
    for order in (list(range(len(trees))), list(range(len(trees)))[::-1]):
        for t in order:
            root, design, rc, fns, launch, keep = trees[t]
            for name, fn in fns.items():
                times[(t, name)].append(event_ms(lambda: call(fn, launch), iters=args.iters))
            times[(t, "wrapper")].append(event_ms(lambda: rc.resize_conv(x, wc, bc, oh, ow),
                                                  iters=args.iters))
    flops = n * oh * ow * 2.0 * 9 * c * 128
    for t, (root, design, rc, fns, launch, keep) in enumerate(trees):
        got_kernel = keep[-1] if design is MMA_SYNC else keep[0]
        call(fns["full"], launch)
        torch.cuda.synchronize()
        got_wrapper = rc.resize_conv(x, wc, bc, oh, ow)
        ms = {k: round(sum(times[(t, k)]) / 2, 4) for k in ("wrapper", *BUILDS)}
        print(json.dumps({
            "tree": os.path.basename(root) or root, "design": design["name"],
            "shape": f"{n}x{h}x{w}x{c} -> {oh}x{ow}x128",
            "kernel_ms": ms["full"], "nogemm_ms": ms["nogemm"], "noresize_ms": ms["noresize"],
            "neither_ms": ms["neither"],
            "wrapper_ms": ms["wrapper"], "wrapper_own_ms": round(ms["wrapper"] - ms["full"], 4),
            "ms_turns": {k: [round(v, 4) for v in times[(t, k)]] for k in ("wrapper", *BUILDS)},
            "tensor_bound_ms": round(flops / 989e12 * 1e3, 4),
            "rel_err": float((got_kernel.float() - want).abs().max()) / scale,
            "wrapper_rel_err": float((got_wrapper.float() - want).abs().max()) / scale,
        }), flush=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
