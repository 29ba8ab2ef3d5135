"""Kernel C and the output-tail kernel on the card, alone: ms per launch and
the split by stage, at the main path's shapes.

    python -m video_depth_anything_torch.bench_motion_tail [--root DIR] [--iters N]

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
"""

from __future__ import annotations

import argparse
import json
import os
import sys

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None, help="checkout to import the port from")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if args.root:
        use_root(args.root)
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
