"""Benchmark evaluation on the card, the counterpart of the root ``eval.py``.

    python -m video_depth_anything_torch.eval --dataset kitti --root /data/KITTI \\
        --encoder vits --checkpoint ckpt.pth --csv out/kitti_metrics.csv
    python -m video_depth_anything_torch.eval --dataset sintel --root /data/Sintel \\
        --random_init --streaming [--kv_cache] --csv out/sintel.csv

Runs every scene of a dataset through the window pipeline, or with
``--streaming`` the feature-cache streaming pipeline (``--kv_cache``: the
KV-cache one), aligns each scene's prediction to its metric ground truth
and writes the per-scene metrics (and TAE where the dataset has cameras) to
``--csv`` (``evals/evaluate.evaluate_dataset``).  The JAX ``eval.py``'s
flags and defaults, plus ``--device``: the card unless ``cpu``, which runs
the plain PyTorch path.  Prints the result as JSON and how often each CUDA
kernel was launched.  Across GPUs (ranks started by ``python -m
torch.distributed.run``): ``--data_parallel`` splits each scene's windows
over the ranks, ``--model_parallel N`` splits the encoder over groups of N
ranks (the window and both streaming modes), ``--pipeline_parallel N``
stages it (the window mode only); rank 0 writes ``--csv``.
"""

from __future__ import annotations

import argparse
import functools
import json
import os

from video_depth_anything_torch.data import DATASETS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Video Depth Anything evaluation (PyTorch/CUDA)")
    p.add_argument("--dataset", required=True, choices=list(DATASETS))
    p.add_argument("--root", required=True)
    p.add_argument("--is_val", action="store_true", help="use the val split where defined")
    p.add_argument("--encoder", default="vits", choices=["vits", "vitb", "vitl"])
    p.add_argument("--checkpoint", default=None,
                   help="torch .pth; default ./checkpoints/video_depth_anything_<encoder>.pth")
    p.add_argument("--random_init", action="store_true", help="seeded random weights")
    p.add_argument("--input_size", type=int, default=518)
    p.add_argument("--fp32", action="store_true", help="fp32 end-to-end (default bf16)")
    p.add_argument("--csv", required=True)
    p.add_argument("--max_scenes", type=int, default=None)
    p.add_argument("--max_frames_per_scene", type=int, default=None)
    p.add_argument("--no_tae", action="store_true")
    p.add_argument("--align_only_first_frame", action="store_true")
    p.add_argument("--streaming", action="store_true")
    p.add_argument("--original", action="store_true",
                   help="force plain sliding-window mode, overriding --streaming "
                        "and its flags (ref eval.py:42-43)")
    p.add_argument("--inference_length", type=int, default=32,
                   help="streaming: motion-module context length (ref eval.py:34)")
    p.add_argument("--keyframe_list", type=int, nargs="+", default=[20],
                   help="streaming: keyframe distance schedule (ref eval.py:36 default [20]); "
                        "lists containing 0 are incompatible with --align_each_new_frame")
    p.add_argument("--align_each_new_frame", action="store_true",
                   help="streaming: per-frame scale/shift realignment (ref eval.py:39)")
    p.add_argument("--stream_chunk", type=int, default=8,
                   help="steady-state streaming frames per model call (1 disables chunking; "
                        "clamped to inference_length + max(keyframes) - 3)")
    p.add_argument("--ring_dtype", choices=["fp32", "fp16", "bf16"], default=None,
                   help="storage dtype of the aligned mode's ring of emitted depths; env "
                        "VDA_RING_DTYPE, else fp32")
    p.add_argument("--skip_tmp_block", action="store_true",
                   help="skip the third motion module (ref eval.py:44)")
    p.add_argument("--kv_cache", action="store_true",
                   help="with --streaming: KV-cache streaming (O(1) work per frame); combines "
                        "with --align_each_new_frame")
    p.add_argument("--data_parallel", action="store_true")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="tensor-parallel: split the ViT weights over N ranks (sliding-window "
                        "and both streaming modes)")
    p.add_argument("--pipeline_parallel", type=int, default=1,
                   help="stage the encoder block chain over N ranks (sliding-window mode; see "
                        "run)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def check_parallel_args(args) -> None:
    """The JAX ``eval.py:82-90`` refusal, with its message."""
    if args.pipeline_parallel > 1 and (args.streaming or args.kv_cache or args.data_parallel
                                       or args.model_parallel > 1):
        raise SystemExit(
            "--pipeline_parallel applies to the sliding-window mode only "
            "and is exclusive with --streaming/--kv_cache/--data_parallel/"
            "--model_parallel")


def normalize_args(args):
    """--original means "no adjustments": force the plain sliding-window
    mode and clear skip_tmp_block (the reference's non-streaming eval branch
    never applies it).  Applying skip_tmp_block in non-streaming eval
    WITHOUT --original is a deliberate extension beyond the reference
    (docs/PARITY.md)."""
    if args.original:
        args.streaming = False
        args.skip_tmp_block = False
    return args


def load_model(args):
    """The ``VDAModel`` of ``args``: seeded (``--random_init``) or from
    ``--checkpoint``, on ``--device``."""
    import torch

    from video_depth_anything_torch.models.vda import VDAModel

    model = VDAModel(args.encoder, device=args.device,
                     dtype=torch.float32 if args.fp32 else torch.bfloat16)
    if args.random_init:
        model.init_params(seed=0)
    else:
        from video_depth_anything_torch.io.checkpoint import load_init_checkpoint

        ckpt = args.checkpoint or f"./checkpoints/video_depth_anything_{args.encoder}.pth"
        model.load_state_dict(load_init_checkpoint(ckpt), strict=True)
    return model


class StreamAdapter:
    """A streaming pipeline behind ``infer_video_depth``, the window
    pipeline's call (the JAX ``eval.py:129-170`` adapters)."""

    def __init__(self, inner, skip_tmp_block: bool):
        self.inner = inner
        self.skip_tmp_block = skip_tmp_block

    def infer_video_depth(self, frames, *a, **k):
        return self.inner.infer(frames, skip_tmp_block=self.skip_tmp_block)


def build_pipeline(args, model):
    """The pipeline of the mode ``args`` ask for, with ``skip_tmp_block``
    bound."""
    if args.streaming and args.kv_cache:
        from video_depth_anything_torch.inference.kv_streaming import KVStreamingPipeline

        return StreamAdapter(KVStreamingPipeline(
            model, input_size=args.input_size, inference_length=args.inference_length,
            align_each_new_frame=args.align_each_new_frame, stream_chunk=args.stream_chunk,
            model_parallel=args.model_parallel), args.skip_tmp_block)
    if args.streaming:
        from video_depth_anything_torch.inference.streaming import StreamingDepthPipeline

        return StreamAdapter(StreamingDepthPipeline(
            model, input_size=args.input_size, inference_length=args.inference_length,
            keyframe_list=tuple(args.keyframe_list),
            align_each_new_frame=args.align_each_new_frame, chunk_size=args.stream_chunk,
            ring_dtype=args.ring_dtype, model_parallel=args.model_parallel), args.skip_tmp_block)
    if args.pipeline_parallel > 1:
        from video_depth_anything_torch.parallel.pipeline_parallel import (
            PipelineParallelVideoDepthPipeline,
        )

        pipeline = PipelineParallelVideoDepthPipeline(
            model, pipeline_parallel=args.pipeline_parallel, input_size=args.input_size)
    elif args.data_parallel or args.model_parallel > 1:
        from video_depth_anything_torch.parallel.data_parallel import (
            DataParallelVideoDepthPipeline,
        )

        pipeline = DataParallelVideoDepthPipeline(model, input_size=args.input_size,
                                                  model_parallel=args.model_parallel)
    else:
        from video_depth_anything_torch.inference.pipeline import VideoDepthPipeline

        pipeline = VideoDepthPipeline(model, input_size=args.input_size)
    if args.skip_tmp_block:
        pipeline.infer_video_depth = functools.partial(pipeline.infer_video_depth,
                                                       skip_tmp_block=True)
    return pipeline


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    check_parallel_args(args)
    args = normalize_args(args)
    import tempfile

    from video_depth_anything_torch.data import get_dataset
    from video_depth_anything_torch.evals.evaluate import evaluate_dataset
    from video_depth_anything_torch.parallel import comm
    from video_depth_anything_torch.run import kernel_launches

    if args.data_parallel or args.model_parallel > 1 or args.pipeline_parallel > 1:
        args.device = str(comm.init_distributed(device=args.device).device)
    kwargs = {"is_val": args.is_val} if args.dataset == "kitti" else {}
    dataset = get_dataset(args.dataset, args.root, **kwargs)
    pipeline = build_pipeline(args, load_model(args))
    before = kernel_launches()
    with tempfile.TemporaryDirectory() as tmp:
        # every rank holds every scene's depth; rank 0 writes the CSV
        csv = args.csv if comm.world().rank == 0 else os.path.join(tmp, "rank.csv")
        result = evaluate_dataset(
            pipeline, dataset, csv, max_scenes=args.max_scenes,
            max_frames_per_scene=args.max_frames_per_scene, compute_tae=not args.no_tae,
            align_only_first_frame=args.align_only_first_frame)
    after = kernel_launches()
    print(json.dumps(result, default=str))
    print("kernel launches: " + json.dumps({k: after[k] - before[k] for k in after}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
