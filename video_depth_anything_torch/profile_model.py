"""Model profiling CLI, the JAX ``profile_model.py`` (the reference's
``Test_singleImage_processing.py``): parameters split encoder against head,
the cost of one window (``utils/profiling.compiled_cost``: FLOPs and bytes
counted op by op on the plain path, the peak device memory above the
weights), the encoder's and the window's times and the head's by
difference, and an optional ``torch.profiler`` trace.  Prints JAX's JSON
keys.  Runs on the card unless ``--device cpu``.

    python -m video_depth_anything_torch.profile_model --encoder vits --size 518 --frames 32
"""

from __future__ import annotations

import argparse
import json


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--encoder", default="vits", choices=["vits", "vitb", "vitl"])
    p.add_argument("--frames", type=int, default=32)
    p.add_argument("--size", type=int, default=518)
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--trace_dir", default=None,
                   help="write a torch.profiler Chrome trace (trace.json) here")
    p.add_argument("--skip_timing", action="store_true")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from video_depth_anything_torch.models.vda import VDAModel
    from video_depth_anything_torch.utils.profiling import (
        compiled_cost,
        component_timings,
        param_counts,
        trace,
    )

    model = VDAModel(args.encoder, device=args.device,
                     dtype=torch.float32 if args.fp32 else torch.bfloat16)
    model.init_params(seed=0)

    report = {"encoder": args.encoder, "frames": args.frames, "size": args.size}
    report.update(param_counts(model.module))

    x = torch.zeros(1, args.frames, args.size, args.size, 3, device=model.device,
                    dtype=model.dtype)
    report["compiled"] = compiled_cost(model.module, x)

    if not args.skip_timing:
        with trace(args.trace_dir):
            report["timings"] = component_timings(model, args.frames, args.size)
        t = report["timings"]["full"]["median_s"]
        report["frames_per_s"] = round(args.frames / t, 2)

    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
