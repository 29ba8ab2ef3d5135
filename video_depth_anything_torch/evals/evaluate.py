"""Benchmark evaluation driver (the JAX package's ``evals/evaluate.py``;
capability of the reference ``eval.py:23-193``).

Iterates a scene dataset, runs batch or streaming inference, aligns each
scene's inverse-depth prediction to metric ground truth, computes the
metric suite (+ TAE when camera parameters are present), and writes the
per-scene CSV with summary rows and run stats.  The same semantics as the
JAX driver; progress is one line per scene on stderr instead of a
progress bar.
"""

from __future__ import annotations

import sys
import time
from typing import Optional

import numpy as np

from video_depth_anything_torch.evals.align import align_prediction, fit_inverse_alignment
from video_depth_anything_torch.evals.metrics import CsvSaver, compute_all
from video_depth_anything_torch.evals.tae import temporal_alignment_error
from video_depth_anything_torch.utils.stats import device_memory_stats, host_rss_mb


def evaluate_dataset(
    pipeline,
    dataset,
    csv_path: str,
    max_scenes: Optional[int] = None,
    max_frames_per_scene: Optional[int] = None,
    compute_tae: bool = True,
    align_only_first_frame: bool = False,
    progress: bool = True,
) -> dict:
    """Run ``pipeline.infer_video_depth`` over every scene of ``dataset``.

    ``dataset[i]`` must return a dict with ``image (N,H,W,3)`` uint8 RGB
    (or float in [0, 1]), ``depth (N,H,W)`` metric, ``valid_depth (N,H,W)``
    bool, and optional ``intrinsics (N,3,3)`` / ``extrinsics (N,4,4)`` /
    ``name``.  ``align_only_first_frame`` fits scale/shift on frame 0 only
    and applies it to the whole scene (ref ``eval.py:168-181``).
    """
    saver = CsvSaver(csv_path)
    n_scenes = len(dataset) if max_scenes is None else min(max_scenes, len(dataset))
    max_depth = getattr(dataset, "max_depth", 80.0)

    total_frames = 0
    t_start = time.time()
    means = []
    for i in range(n_scenes):
        sample = dataset[i]
        frames = sample["image"]
        if frames.dtype != np.uint8:
            frames = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
        if max_frames_per_scene:
            frames = frames[:max_frames_per_scene]
        gt = np.asarray(sample["depth"])[: len(frames)]
        valid = np.asarray(sample["valid_depth"]).astype(bool)[: len(frames)]
        name = sample.get("name", f"scene_{i:04d}")

        pred, _ = pipeline.infer_video_depth(frames)
        n_out = len(pred)
        if n_out == 0:
            # streaming mode predicts nothing for scenes shorter than its
            # inference length (reference eval.py:126 skips them too)
            if progress:
                print(f"scenes {i + 1}/{n_scenes}: {name} predicted no frame, skipped",
                      file=sys.stderr, flush=True)
            continue
        # streaming without alignment predicts fewer frames; evaluate the tail
        gt, valid = gt[-n_out:], valid[-n_out:]

        if align_only_first_frame:
            scale, shift = fit_inverse_alignment(pred[0], gt[0], valid[0])
            aligned = np.clip((pred - shift) / scale, 0.0, 1.0)
            aligned = np.where(aligned == 0.0, 1e-4, aligned)
            aligned = np.clip(1.0 / aligned, 0.0, max_depth)
        else:
            aligned, scale, shift = align_prediction(pred, gt, valid, max_depth)

        metrics = compute_all(aligned, gt, valid)
        tae = None
        if compute_tae and "intrinsics" in sample and "extrinsics" in sample:
            # cameras must follow the same truncate-then-tail slicing as gt
            intr = np.asarray(sample["intrinsics"])[: len(frames)][-n_out:]
            extr = np.asarray(sample["extrinsics"])[: len(frames)][-n_out:]
            tae = temporal_alignment_error(aligned, intr, extr, valid)
        saver.add_scene(name, metrics, scale, shift, n_frames=n_out, tae=tae)
        means.append(metrics["AbsoluteRelative"])
        total_frames += n_out
        if progress:
            print(f"scenes {i + 1}/{n_scenes}: {name} {n_out} frames AbsRel "
                  f"{metrics['AbsoluteRelative']:.4f} delta1 {metrics['Delta1']:.4f}"
                  + ("" if tae is None else f" TAE {tae:.4f}"), file=sys.stderr, flush=True)

    wall = time.time() - t_start
    fps = total_frames / wall if wall else 0.0
    saver.summarize(
        extra_header=["total_frames", "wall_s", "fps", "host_rss_mb"],
        extra_row=[total_frames, round(wall, 2), round(fps, 2), round(host_rss_mb(), 1)],
    )
    return {
        "scenes": n_scenes,
        "frames": total_frames,
        "fps": fps,
        "mean_absrel": float(np.mean(means)) if means else None,
        "csv": csv_path,
        "device_memory": device_memory_stats(),
    }
