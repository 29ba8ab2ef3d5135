"""Quickstart: video → depth in a few lines of the library surface (the JAX
``examples/quickstart.py``).  Runs on the card unless ``--device cpu``.

    python -m video_depth_anything_torch.examples.quickstart video.mp4 [--device cuda]
"""

import argparse

import torch

from video_depth_anything_torch.inference.pipeline import VideoDepthPipeline
from video_depth_anything_torch.io.video import read_video_frames, save_video
from video_depth_anything_torch.models.vda import VDAModel


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("video")
    p.add_argument("--output", default="depth.mp4")
    p.add_argument("--input_size", type=int, default=518)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    model = VDAModel("vits", device=args.device, dtype=torch.bfloat16)
    model.init_params(seed=0)  # or model.load_state_dict(io.checkpoint.load_pth(...))

    frames, fps = read_video_frames(args.video, process_length=64, max_res=640)
    depths, fps = VideoDepthPipeline(model, input_size=args.input_size).infer_video_depth(
        frames, fps, progress=True)
    save_video(depths, args.output, fps=fps, is_depths=True)
    print(f"wrote {args.output} ({len(depths)} frames)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
