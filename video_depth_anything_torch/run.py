"""Video → depth on the card: sliding-window, feature-cache streaming or
KV-cache streaming mode.

    python -m video_depth_anything_torch.run --input_video clip.mp4 \\
        --output_dir ./outputs --encoder vits --random_init
    python -m video_depth_anything_torch.run --input_video clip.mp4 --random_init \\
        --process_single_image [--align_each_new_frame] [--attn_impl auto:fast]
    python -m video_depth_anything_torch.run --input_video clip.mp4 --random_init \\
        --process_single_image --kv_cache [--align_each_new_frame] [--stream_chunk 8]

Writes ``<name>_depth.mp4`` and, as the JAX ``run.py``'s ``_save_outputs``
names them, ``<name>_orig.mp4`` (``--save_orig``), ``<name>_depth.npz``
(``--save_npz``), ``<name>_depths.tiff`` (``--save_tiff``), ``<name>_exr/
NNNNN.exr`` (``--save_exr``), ``<name>_vis.mp4`` (``--save_vis``, Spectral)
and a record appended to ``inference_log.txt`` (``--save_stats``), and
prints the frames/s and how often each CUDA kernel was launched, the
exact and the fast variant of Kernel A apart, the fp32 kernels (``--fp32``)
under names of their own.  Runs on the card; ``--device cpu`` runs the
plain PyTorch path.  ``--fp32_island`` (bf16 only, as the JAX
``run.py:205-211``) runs output_conv2 in fp32.  The flags are the JAX
``run.py``'s for these modes; ``--original`` overrides the streaming flags
(``normalize_args``).  ``--kv_cache`` takes ``--inference_length``,
``--align_each_new_frame``, ``--stream_chunk``, ``--host_upsample`` and
``--transfer_dtype``, as the JAX ``run.py:297-305`` does, and ignores
``--keyframe_list`` and ``--ring_dtype``.  ``--transfer_dtype``,
``--ring_dtype`` and ``--host_upsample`` default to ``VDA_TRANSFER_DTYPE``,
``VDA_RING_DTYPE`` and ``VDA_HOST_UPSAMPLE`` (then fp32, fp32, off), and
``--shape_bucket`` snaps the window mode's model resolution
(``utils/transform.bucket_model_size``).

Across GPUs, one rank a GPU (``parallel/``), with the JAX ``run.py``'s
flags: ranks started by ``python -m torch.distributed.run --nproc_per_node
N -m video_depth_anything_torch.run ...``, or one a host by ``--coordinator
host:port --num_hosts N --host_id i``.  ``--data_parallel`` splits the
windows over the ranks, ``--model_parallel N`` splits the encoder over
groups of N ranks (also in both streaming modes), ``--pipeline_parallel N``
stages the encoder's blocks over N ranks (sliding-window only), and the
multi-host flags make each host a data group (sliding-window only).  In
the window mode every data group decodes only its span of frames, counted
from the container's header.  Every rank holds the whole result; rank 0
writes the outputs, and every rank prints its launch counts.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Video Depth Anything (PyTorch/CUDA)")
    p.add_argument("--input_video", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="./outputs")
    p.add_argument("--encoder", type=str, default="vits", choices=["vits", "vitb", "vitl"],
                   help="vits, vitb and vitl run on the card and on the CPU")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="torch .pth; default ./checkpoints/video_depth_anything_<encoder>.pth")
    p.add_argument("--random_init", action="store_true", help="seeded random weights")
    p.add_argument("--input_size", type=int, default=518)
    p.add_argument("--max_res", type=int, default=1280)
    p.add_argument("--max_len", type=int, default=-1)
    p.add_argument("--target_fps", type=int, default=-1)
    p.add_argument("--fp32", action="store_true", help="fp32 end-to-end (default bf16 + fp32 islands)")
    p.add_argument("--fp32_island", action="store_true",
                   help="force the reference's fp32 output_conv2 island in bf16 mode (the output "
                        "tail kernel is then refused, as in JAX)")
    p.add_argument("--skip_tmp_block", action="store_true", help="skip the third motion module")
    p.add_argument("--original", action="store_true",
                   help="reference-default sliding-window mode (overrides the streaming flags)")
    p.add_argument("--process_single_image", action="store_true",
                   help="feature-cache streaming: one frame per step")
    p.add_argument("--inference_length", type=int, default=32)
    p.add_argument("--keyframe_list", type=int, nargs="+", default=[20],
                   help="streaming keyframe distances; lists with 0 are refused with "
                        "--align_each_new_frame")
    p.add_argument("--align_each_new_frame", action="store_true")
    p.add_argument("--stream_chunk", type=int, default=8,
                   help="steady streaming frames per batch (1: one at a time; clamped to "
                        "inference_length + max(keyframes) - 3)")
    p.add_argument("--ring_dtype", choices=["fp32", "fp16", "bf16"], default=None,
                   help="storage dtype of the aligned mode's ring of emitted depths; env "
                        "VDA_RING_DTYPE, else fp32")
    p.add_argument("--transfer_dtype", choices=["fp32", "fp16"], default=None,
                   help="dtype of emitted depth maps on their way to the host (window and "
                        "streaming modes; fp16 halves the copy, the stitch and the fits stay "
                        "fp32); env VDA_TRANSFER_DTYPE, else fp32")
    p.add_argument("--kv_cache", action="store_true",
                   help="with --process_single_image: KV-cache streaming, O(1) work per frame "
                        "(each motion module attends the new frame over its K/V caches); "
                        "--keyframe_list is ignored (the first frame is the one pinned "
                        "reference with --align_each_new_frame)")
    p.add_argument("--attn_impl", type=str, default="auto",
                   help="auto|pallas|xla with an optional :fast suffix (auto:fast: Kernel A's "
                        "no-max softmax, exact while attention logits stay inside fp32's exp2 "
                        "domain, about +-88); xla turns every kernel of the attention and motion "
                        "modules off; pallas also sends every motion-module attention in the "
                        "temporal kernel's domain (head widths 8 to 128) to it")
    p.add_argument("--window_batch", type=int, default=None,
                   help="windows per model call (default 4 for vits/vitb, 1 for vitl)")
    p.add_argument("--host_upsample", action="store_true", default=None,
                   help="upsample depth to the source resolution on the host; env "
                        "VDA_HOST_UPSAMPLE=1")
    p.add_argument("--shape_bucket", type=int, default=None,
                   help="snap the window mode's model resolution to multiples of this (a "
                        "multiple of 14), so that clips of many aspect ratios share shapes")
    p.add_argument("--data_parallel", action="store_true",
                   help="shard frame windows over the ranks (one a GPU)")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="tensor-parallel group size: shard the ViT qkv/proj/fc1/fc2 weights "
                        "Megatron-style over N ranks (windows shard over the remaining ranks; "
                        "implies the data-parallel pipeline; also the streaming modes)")
    p.add_argument("--pipeline_parallel", type=int, default=1,
                   help="pipeline-parallel stage count: stage the ViT encoder's block chain over "
                        "N ranks (GPipe over frame microbatches, point-to-point hops); "
                        "sliding-window mode only, exclusive with "
                        "--data_parallel/--model_parallel")
    p.add_argument("--pp_microbatches", type=int, default=None,
                   help="pipeline-parallel microbatch count (must divide windows*32 frames per "
                        "call; default: the divisor of that nearest 2*stages)")
    p.add_argument("--coordinator", type=str, default=os.environ.get("VDA_COORDINATOR"),
                   help="multi-host: coordinator address host:port (the process group's TCP "
                        "rendezvous); env VDA_COORDINATOR")
    p.add_argument("--num_hosts", type=int,
                   default=int(os.environ.get("VDA_NUM_HOSTS", "0")) or None,
                   help="multi-host: total process count; env VDA_NUM_HOSTS.  Window spans are "
                        "partitioned from the container's frame-count header before any "
                        "decode; for VFR or estimated-header containers set "
                        "VDA_VALIDATE_FRAME_COUNT=1 (fail fast on bad headers) and "
                        "VDA_SEEK_MODE=grab (frame-exact range seeks)")
    p.add_argument("--host_id", type=int,
                   default=(int(os.environ["VDA_HOST_ID"]) if "VDA_HOST_ID" in os.environ
                            else None),
                   help="multi-host: this process's id; env VDA_HOST_ID")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--grayscale", action="store_true")
    p.add_argument("--save_npz", action="store_true")
    p.add_argument("--save_exr", action="store_true",
                   help="depth frames as EXR files (needs a cv2 with an OpenEXR writer)")
    p.add_argument("--save_tiff", action="store_true",
                   help="depths as a multi-page float32 TIFF stack (needs PIL)")
    p.add_argument("--save_orig", action="store_true", help="the decoded frames as a video")
    p.add_argument("--save_vis", action="store_true", help="depths in the Spectral colormap")
    p.add_argument("--save_stats", action="store_true",
                   help="append a JSON record of the run to inference_log.txt")
    return p


def kernel_launches() -> dict:
    from video_depth_anything_torch.ops.flash_attention import flash_attention, flash_attention_bwd
    from video_depth_anything_torch.ops.motion_module import fused_motion_module
    from video_depth_anything_torch.ops.output_tail import output_tail
    from video_depth_anything_torch.ops.temporal_attention import temporal_attention

    counts = {f.__name__: f.launches for f in (flash_attention, flash_attention_bwd,
                                                temporal_attention, fused_motion_module,
                                                output_tail)}
    counts["flash_attention_fast"] = flash_attention.fast_launches
    counts["flash_attention_wide"] = flash_attention.wide_launches
    counts["flash_attention_wide_f32"] = flash_attention.wide_f32_launches
    for f in (flash_attention, temporal_attention, fused_motion_module):
        counts[f"{f.__name__}_f32"] = f.f32_launches
    counts["fused_motion_module_wide"] = fused_motion_module.wide_launches
    counts["fused_motion_module_wide_f32"] = fused_motion_module.wide_f32_launches
    counts["temporal_attention_any"] = temporal_attention.any_launches
    counts["temporal_attention_any_f32"] = temporal_attention.any_f32_launches
    return counts


def host_paths(pipe=None) -> dict:
    """Which host path ran last: the decoder (``native`` or ``cv2``), the
    preprocessing (``native`` or ``cv2``) and, in the data-parallel window
    pipeline, the window gather (``native`` or ``numpy``)."""
    from video_depth_anything_torch.io.video import last_decoder
    from video_depth_anything_torch.utils.transform import last_preprocessor

    paths = {"decode": last_decoder(), "preprocess": last_preprocessor()}
    if getattr(pipe, "gather_path", None) is not None:
        paths["gather"] = pipe.gather_path
    return paths


def normalize_args(args):
    """``--original`` runs the plain sliding-window mode of the reference,
    without ``--skip_tmp_block`` (JAX ``run.py:149-163``)."""
    if args.original:
        args.process_single_image = False
        args.skip_tmp_block = False
    return args


def check_parallel_args(args, multihost: bool) -> None:
    """The JAX ``run.py``'s refusals (``:185-198``), with its messages."""
    if multihost and args.process_single_image:
        raise SystemExit("--coordinator/--num_hosts is sliding-window only "
                         "(windows shard across hosts; streaming is sequential)")
    if args.pipeline_parallel > 1:
        if args.data_parallel or args.model_parallel > 1:
            raise SystemExit("--pipeline_parallel is exclusive with "
                             "--data_parallel/--model_parallel")
        if args.process_single_image or multihost:
            raise SystemExit("--pipeline_parallel applies to the sliding-window mode "
                             "only (not --process_single_image/--kv_cache/--coordinator)")


def main(argv=None) -> int:
    args = normalize_args(build_parser().parse_args(argv))
    multihost = args.coordinator is not None or (args.num_hosts or 1) > 1
    check_parallel_args(args, multihost)
    import torch

    from video_depth_anything_torch.config import get_model_config
    from video_depth_anything_torch.inference.kv_streaming import KVStreamingPipeline
    from video_depth_anything_torch.inference.pipeline import VideoDepthPipeline
    from video_depth_anything_torch.inference.streaming import StreamingDepthPipeline
    from video_depth_anything_torch.io.video import read_video_frames
    from video_depth_anything_torch.models.vda import VDAModel
    from video_depth_anything_torch.parallel import comm

    parallel = (multihost or args.data_parallel or args.model_parallel > 1
                or args.pipeline_parallel > 1)
    device = args.device
    if parallel:
        world = comm.init_distributed(args.coordinator, args.num_hosts, args.host_id,
                                      device=args.device)
        device = world.device
    world = comm.world()
    os.makedirs(args.output_dir, exist_ok=True)
    cfg = None
    if args.fp32_island and not args.fp32:
        cfg = dataclasses.replace(get_model_config(args.encoder), fp32_head_island=True)
    model = VDAModel(args.encoder, device=device,
                     dtype=torch.float32 if args.fp32 else torch.bfloat16,
                     cfg=cfg, attn_impl=args.attn_impl)
    if args.random_init:
        model.init_params(seed=0)
    else:
        from video_depth_anything_torch.io.checkpoint import load_pth

        ckpt = args.checkpoint or f"./checkpoints/video_depth_anything_{args.encoder}.pth"
        model.load_state_dict(load_pth(ckpt), strict=True)

    before = kernel_launches()
    window = dict(input_size=args.input_size, shape_bucket=args.shape_bucket,
                  window_batch=args.window_batch, host_upsample=args.host_upsample,
                  transfer_dtype=args.transfer_dtype)
    if parallel and not args.process_single_image:
        # the windows split over the data groups: each decodes its span only
        from video_depth_anything_torch.io.video import count_video_frames, read_video_frame_range
        from video_depth_anything_torch.parallel.data_parallel import (
            DataParallelVideoDepthPipeline,
        )

        n_frames, fps = count_video_frames(args.input_video, args.max_len, args.target_fps)
        if args.target_fps > 0:
            fps = args.target_fps
        print(f"{n_frames} sampled frames @ {fps:.2f} fps (from the container's header)")
        if args.pipeline_parallel > 1:
            from video_depth_anything_torch.parallel.pipeline_parallel import (
                PipelineParallelVideoDepthPipeline,
            )

            pipe = PipelineParallelVideoDepthPipeline(
                model, pipeline_parallel=args.pipeline_parallel,
                num_microbatches=args.pp_microbatches, **window)
        else:
            pipe = DataParallelVideoDepthPipeline(model, model_parallel=args.model_parallel,
                                                  **window)
        t0 = time.time()
        depths, fps = pipe.infer_frame_range(
            n_frames, lambda a, b: read_video_frame_range(args.input_video, a, b,
                                                          args.target_fps, args.max_res),
            fps, skip_tmp_block=args.skip_tmp_block, progress=True)
        wall = time.time() - t0
        print(f"rank {world.rank} decoded frames [{pipe.decoded[0]}, {pipe.decoded[1]}) "
              f"of {n_frames}")
        frames = None
    else:
        frames, fps = read_video_frames(args.input_video, args.max_len, args.target_fps,
                                        args.max_res)
        print(f"decoded {len(frames)} frames @ {fps:.2f} fps, "
              f"{frames.shape[2]}x{frames.shape[1]}")
        t0 = time.time()
        if args.process_single_image and args.kv_cache:
            pipe = KVStreamingPipeline(
                model, input_size=args.input_size, inference_length=args.inference_length,
                align_each_new_frame=args.align_each_new_frame, stream_chunk=args.stream_chunk,
                host_upsample=args.host_upsample, transfer_dtype=args.transfer_dtype,
                model_parallel=args.model_parallel)
            depths, fps = pipe.infer(frames, fps, skip_tmp_block=args.skip_tmp_block,
                                     progress=True)
        elif args.process_single_image:
            pipe = StreamingDepthPipeline(
                model, input_size=args.input_size, inference_length=args.inference_length,
                keyframe_list=tuple(args.keyframe_list),
                align_each_new_frame=args.align_each_new_frame, chunk_size=args.stream_chunk,
                ring_dtype=args.ring_dtype, host_upsample=args.host_upsample,
                transfer_dtype=args.transfer_dtype, model_parallel=args.model_parallel)
            depths, fps = pipe.infer(frames, fps, skip_tmp_block=args.skip_tmp_block,
                                     progress=True)
        else:
            pipe = VideoDepthPipeline(model, **window)
            depths, fps = pipe.infer_video_depth(frames, fps, skip_tmp_block=args.skip_tmp_block,
                                                 progress=True)
        wall = time.time() - t0
    after = kernel_launches()
    launches = json.dumps({k: after[k] - before[k] for k in after})
    print("host paths: " + json.dumps(host_paths(pipe)))
    if world.rank == 0:  # every rank holds the whole result; rank 0 writes
        if frames is None:  # decoded by span: only --save_orig decodes the whole clip here
            frames = read_video_frame_range(args.input_video, 0, n_frames, args.target_fps,
                                            args.max_res) if args.save_orig else \
                np.zeros((0,) + depths.shape[1:] + (3,), np.uint8)
        _save_outputs(args, frames, depths, fps, wall, model.device)
    else:
        print(f"rank {world.rank}: {len(depths)} frames in {wall:.2f}s (outputs written by "
              "rank 0)")
    if world.backend is None:
        print("kernel launches: " + launches)
    else:
        print(comm.rank_line(json.loads(launches)), flush=True)
    return 0


def _save_outputs(args, frames, depths, fps, wall, device) -> None:
    """The outputs the flags ask for, under the JAX ``run.py``'s names."""
    from video_depth_anything_torch.io.video import colorize_depth, save_video

    base = os.path.splitext(os.path.basename(args.input_video))[0]
    out_video = os.path.join(args.output_dir, f"{base}_depth.mp4")
    save_video(depths, out_video, fps=fps, is_depths=True, grayscale=args.grayscale)
    print(f"wrote {out_video}")
    if args.save_orig:
        save_video(frames, os.path.join(args.output_dir, f"{base}_orig.mp4"), fps=fps)
    if args.save_npz:
        # uncompressed (JAX's run.py deflates): float32 depth barely
        # deflates, and the deflate took longer than the clip's inference;
        # np.load reads both alike
        np.savez(os.path.join(args.output_dir, f"{base}_depth.npz"), depth=depths)
    if args.save_tiff:
        from video_depth_anything_torch.io.video import write_tiff_stack

        write_tiff_stack(os.path.join(args.output_dir, f"{base}_depths.tiff"), depths)
    if args.save_exr:
        import cv2

        exr_dir = os.path.join(args.output_dir, f"{base}_exr")
        os.makedirs(exr_dir, exist_ok=True)
        for i, d in enumerate(depths):
            cv2.imwrite(os.path.join(exr_dir, f"{i:05d}.exr"), d)
    if args.save_vis:
        save_video(colorize_depth(depths, spectral=True),
                   os.path.join(args.output_dir, f"{base}_vis.mp4"), fps=fps)
    if args.save_stats:
        from video_depth_anything_torch.utils.stats import append_run_log

        append_run_log(os.path.join(args.output_dir, "inference_log.txt"), args=vars(args),
                       n_frames=len(frames) or len(depths), n_depths=len(depths), wall_s=wall,
                       device=device)
    print(f"{len(depths)} frames in {wall:.2f}s = {len(depths) / wall:.2f} FPS end-to-end")


if __name__ == "__main__":
    raise SystemExit(main())
