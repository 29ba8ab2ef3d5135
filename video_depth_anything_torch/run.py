"""Video → depth on the card, sliding-window mode.

    python -m video_depth_anything_torch.run --input_video clip.mp4 \\
        --output_dir ./outputs --encoder vits --random_init

Writes ``<name>_depth.mp4`` (and ``<name>_depth.npz`` with ``--save_npz``)
and prints the frames/s and how often each CUDA kernel was launched.
Runs on the card; ``--device cpu`` runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Video Depth Anything (PyTorch/CUDA)")
    p.add_argument("--input_video", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="./outputs")
    p.add_argument("--encoder", type=str, default="vits", choices=["vits", "vitb", "vitl"],
                   help="vits and vitl on the card; vitb on the CPU only for now")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="torch .pth; default ./checkpoints/video_depth_anything_<encoder>.pth")
    p.add_argument("--random_init", action="store_true", help="seeded random weights")
    p.add_argument("--input_size", type=int, default=518)
    p.add_argument("--max_res", type=int, default=1280)
    p.add_argument("--max_len", type=int, default=-1)
    p.add_argument("--target_fps", type=int, default=-1)
    p.add_argument("--fp32", action="store_true", help="fp32 end to end (CPU only for now)")
    p.add_argument("--skip_tmp_block", action="store_true", help="skip the third motion module")
    p.add_argument("--window_batch", type=int, default=None,
                   help="windows per model call (default 4 for vits/vitb, 1 for vitl)")
    p.add_argument("--host_upsample", action="store_true",
                   help="upsample depth to the source resolution on the host")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--grayscale", action="store_true")
    p.add_argument("--save_npz", action="store_true")
    return p


def kernel_launches() -> dict:
    from video_depth_anything_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from video_depth_anything_torch.ops.motion_module import fused_motion_module
    from video_depth_anything_torch.ops.output_tail import output_tail
    from video_depth_anything_torch.ops.temporal_attention import temporal_attention

    return {f.__name__: f.launches for f in (flash_attention, flash_attention_bwd,
                                              temporal_attention, fused_motion_module,
                                              output_tail)}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from video_depth_anything_torch.inference.pipeline import VideoDepthPipeline
    from video_depth_anything_torch.io.video import read_video_frames, save_video
    from video_depth_anything_torch.models.vda import VDAModel

    os.makedirs(args.output_dir, exist_ok=True)
    model = VDAModel(args.encoder, device=args.device,
                     dtype=torch.float32 if args.fp32 else torch.bfloat16)
    if args.random_init:
        model.init_params(seed=0)
    else:
        from video_depth_anything_torch.io.checkpoint import load_pth

        ckpt = args.checkpoint or f"./checkpoints/video_depth_anything_{args.encoder}.pth"
        model.load_state_dict(load_pth(ckpt), strict=True)

    frames, fps = read_video_frames(args.input_video, args.max_len, args.target_fps, args.max_res)
    print(f"decoded {len(frames)} frames @ {fps:.2f} fps, {frames.shape[2]}x{frames.shape[1]}")
    before = kernel_launches()
    t0 = time.time()
    pipe = VideoDepthPipeline(model, input_size=args.input_size,
                              window_batch=args.window_batch, host_upsample=args.host_upsample)
    depths, fps = pipe.infer_video_depth(frames, fps, skip_tmp_block=args.skip_tmp_block)
    wall = time.time() - t0

    base = os.path.splitext(os.path.basename(args.input_video))[0]
    out_video = os.path.join(args.output_dir, f"{base}_depth.mp4")
    save_video(depths, out_video, fps=fps, is_depths=True, grayscale=args.grayscale)
    print(f"wrote {out_video}")
    if args.save_npz:
        np.savez_compressed(os.path.join(args.output_dir, f"{base}_depth.npz"), depth=depths)
    after = kernel_launches()
    print(f"{len(depths)} frames in {wall:.2f}s = {len(depths) / wall:.2f} FPS end-to-end")
    print("kernel launches: " + json.dumps({k: after[k] - before[k] for k in after}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
