"""Comparative evaluation, the counterpart of the root ``compare.py``
(capability of reference ``calculate_metrics.py:32-265``): run inference
(optionally as ``python -m video_depth_anything_torch.run`` subprocesses)
for several method configurations over a video, first-frame align all
methods to a common reference, compute Abs/MSE metrics, and render
side-by-side comparison videos.

    # compare precomputed outputs
    python -m video_depth_anything_torch.compare --video v.mp4 \\
        --method base=out/base_depth.npz --method stream=out/stream_depth.npz --out_dir cmp/

    # let compare drive the port's run CLI itself
    python -m video_depth_anything_torch.compare --video v.mp4 --run "base:--random_init" \\
        --run "skip:--random_init --skip_tmp_block" --out_dir cmp/

The JAX ``compare.py``'s flags, plus ``--device`` (given to every ``--run``
before its own flags, so that a run's ``--device`` wins; the card unless
``cpu``).  ``run_methods`` and ``score_methods`` are the steps before the
two renderings (which need matplotlib), for callers that want
``comparison.json`` alone.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_depth_npz(path: str) -> np.ndarray:
    """Load a depth stack from .npz or a multi-page .tiff (the reference's
    comparative pipeline consumes TIFF stacks, ``calculate_metrics.py:141-163``)."""
    if path.endswith((".tiff", ".tif")):
        from video_depth_anything_torch.io.video import read_tiff_stack

        return read_tiff_stack(path)
    data = np.load(path)
    key = "depth" if "depth" in data else list(data.keys())[0]
    return data[key]


def first_frame_align(pred: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Scale/shift-fit frame 0 of ``pred`` to frame 0 of ``ref``, apply to
    the whole stack (ref ``calculate_metrics.py:174-204``)."""
    from video_depth_anything_torch.ops.scale_shift import compute_scale_and_shift

    s, t = compute_scale_and_shift(pred[0], ref[0])
    return pred * s + t


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="comparative depth evaluation (PyTorch/CUDA)")
    p.add_argument("--video", required=True)
    p.add_argument("--method", action="append", default=[],
                   help="name=path_to_depth.npz (repeatable)")
    p.add_argument("--run", action="append", default=[],
                   help='name:"run flags" -- runs python -m video_depth_anything_torch.run '
                        "as a subprocess")
    p.add_argument("--gt_npz", default=None, help="optional ground-truth depth npz")
    p.add_argument("--out_dir", default="./compare_out")
    p.add_argument("--fps", type=float, default=10)
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="device of the --run subprocesses: cuda (default) or cpu")
    return p


def run_methods(video: str, runs, out_dir: str, device: str) -> dict:
    """``{name: depth stack}`` of each ``name:"run flags"`` spec, run as
    ``python -m video_depth_anything_torch.run`` writing ``<out_dir>/run_<name>/``."""
    base = os.path.splitext(os.path.basename(video))[0]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        x for x in (PACKAGE_ROOT, os.environ.get("PYTHONPATH")) if x))
    methods = {}
    for spec in runs:
        name, flags = spec.split(":", 1)
        run_dir = os.path.join(out_dir, f"run_{name}")
        cmd = [
            sys.executable, "-m", "video_depth_anything_torch.run", "--input_video", video,
            "--output_dir", run_dir, "--save_npz", "--device", device, *flags.split(),
        ]
        print("running:", " ".join(cmd), flush=True)
        subprocess.run(cmd, check=True, env=env)
        methods[name] = _load_depth_npz(os.path.join(run_dir, f"{base}_depth.npz"))
    return methods


def score_methods(methods: dict, gt, out_dir: str):
    """First-frame align every method to ``gt`` (or, without it, to the
    first method), score Abs/MSE against that reference, and write
    ``<out_dir>/comparison.json``.  Returns ``(aligned stacks, rows)``."""
    from video_depth_anything_torch.evals.metrics import abs_diff, mse

    ref_name = next(iter(methods))
    ref = gt if gt is not None else methods[ref_name]

    aligned, rows = {}, {}
    for name, pred in methods.items():
        n = min(len(pred), len(ref))
        # a method with fewer frames (e.g. streaming) outputs the video's
        # LAST n frames — align and score against the reference tail so the
        # frame pairing is temporally consistent
        ref_n = ref[len(ref) - n :]
        a = first_frame_align(pred[len(pred) - n :], ref_n)
        aligned[name] = a
        rows[name] = {
            "frames": int(n),
            "abs_vs_ref": abs_diff(a, ref_n),
            "mse_vs_ref": mse(a, ref_n),
        }

    with open(os.path.join(out_dir, "comparison.json"), "w") as f:
        json.dump({"reference": "gt" if gt is not None else ref_name, "methods": rows}, f, indent=2)
    print(json.dumps(rows, indent=2))
    return aligned, rows


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    from video_depth_anything_torch.utils.device import resolve_device

    resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    methods = {}
    for spec in args.method:
        name, path = spec.split("=", 1)
        methods[name] = _load_depth_npz(path)
    methods.update(run_methods(args.video, args.run, args.out_dir, args.device))
    if not methods:
        p.error("no methods given (--method or --run)")

    gt = _load_depth_npz(args.gt_npz) if args.gt_npz else None
    aligned, _ = score_methods(methods, gt, args.out_dir)
    base = os.path.splitext(os.path.basename(args.video))[0]

    from video_depth_anything_torch.evals.visualize import (
        render_comparison_video,
        render_money_plot,
    )
    from video_depth_anything_torch.io.video import read_video_frames

    rgb, fps = read_video_frames(args.video, max_res=640)
    if args.fps > 0:
        fps = args.fps

    # render the common TAIL so panels of different-length methods show the
    # same video moments side by side
    n = min(len(rgb), *(len(a) for a in aligned.values()))

    def tail(x):
        return x[len(x) - n :]

    render_money_plot(
        tail(rgb),
        {k: tail(v) for k, v in aligned.items()},
        os.path.join(args.out_dir, f"{base}_money.mp4"),
        fps=fps,
        max_frames=args.max_frames,
    )
    render_comparison_video(
        tail(rgb),
        tail(gt) if gt is not None else None,
        {k: tail(v) for k, v in aligned.items()},
        os.path.join(args.out_dir, f"{base}_compare.mp4"),
        fps=fps,
        max_frames=args.max_frames,
    )
    print(f"wrote {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
