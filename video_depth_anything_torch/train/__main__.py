"""Temporal fine-tuning CLI, the counterpart of the root ``train.py``.

    python -m video_depth_anything_torch.train --dataset pointodyssey \\
        --root /data/po --encoder vits --steps 1000 --clip_len 8 --out ckpt_out

Same flags and defaults as ``train.py``, plus ``--device`` (the card unless
``cpu``).  Trains on the card in bf16; ``--device cpu`` runs the plain
PyTorch path.  Writes ``train_log.jsonl`` (the JAX CLI's lines), a
resumable ``state_latest.pt`` (parameters, optimizer state, step) and
reference-keyed ``step_<n>.pth`` weights, which this package and the JAX
package both load.

Across GPUs, one rank a GPU:

    python -m torch.distributed.run --standalone --nproc_per_node 4 \
        -m video_depth_anything_torch.train ... [--model_parallel 2] [--zero1]

A world of more than one rank trains over a ``data × model`` grid
(``--model_parallel`` ranks a model group), as the JAX CLI builds a mesh
when it has more than one device: every rank draws the same seeded global
batch and takes its slice, ``--zero1`` shards the optimizer moments over
the data group (``train/trainer.py``), and rank 0 logs and writes the
checkpoints (gathered whole).
"""

from __future__ import annotations

import argparse
import json
import os
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Video Depth Anything training (PyTorch/CUDA)")
    p.add_argument("--dataset", action="append", required=True,
                   help="dataset name (repeatable): kitti, vkitti, sintel, tartanair, "
                        "pointodyssey, dynamicreplica, sceneflow or irs")
    p.add_argument("--root", action="append", required=True,
                   help="dataset root, one per --dataset")
    p.add_argument("--encoder", default="vits", choices=["vits", "vitb", "vitl"])
    p.add_argument("--init_checkpoint", default=None, help="reference-keyed .pth")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--clip_len", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--input_size", type=int, default=266)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--tgm_weight", type=float, default=10.0)
    p.add_argument("--warmup_steps", type=int, default=0,
                   help="linear LR warmup steps (0 = constant LR)")
    p.add_argument("--decay_steps", type=int, default=0,
                   help="cosine decay horizon after warmup (0 = none)")
    p.add_argument("--accum_steps", type=int, default=1,
                   help="gradient-accumulation micro-batches per update")
    p.add_argument("--augment", action="store_true",
                   help="per-clip geometric and photometric augmentation (data/augment.py)")
    p.add_argument("--train_encoder", action="store_true")
    p.add_argument("--zero1", action="store_true",
                   help="shard optimizer state over the data group (ZeRO-1; Adam moments are 2x "
                        "params in fp32)")
    p.add_argument("--remat_motion", action="store_true",
                   help="recompute the motion modules in the backward")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="tensor-parallel ranks a model group (a world of more than one rank)")
    p.add_argument("--log_every", type=int, default=20)
    p.add_argument("--eval_every", type=int, default=0,
                   help="validate every N steps on held-out clips: scale/shift-aligned AbsRel "
                        "and delta1 in disparity space, logged with the step metrics (0 = off)")
    p.add_argument("--eval_clips", type=int, default=2,
                   help="held-out clips for --eval_every (fixed seed, sampled once)")
    p.add_argument("--save_every", type=int, default=500)
    p.add_argument("--out", default="./checkpoints_out")
    p.add_argument("--resume", action="store_true",
                   help="resume params/optimizer/step from <out>/state_latest.pt")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if len(args.dataset) != len(args.root):
        raise ValueError("give one --root per --dataset")
    import dataclasses

    import numpy as np
    import torch

    from video_depth_anything_torch.config import get_model_config
    from video_depth_anything_torch.data import get_dataset
    from video_depth_anything_torch.data.augment import AugmentConfig
    from video_depth_anything_torch.data.clips import ClipSampler, Prefetcher
    from video_depth_anything_torch.io.checkpoint import load_init_checkpoint, save_pth
    from video_depth_anything_torch.models.vda import VDAModel
    from video_depth_anything_torch.ops.scale_shift import compute_scale_and_shift
    from video_depth_anything_torch.parallel.comm import init_distributed, rank_line
    from video_depth_anything_torch.run import kernel_launches
    from video_depth_anything_torch.parallel.mesh import create_grid, full_state_dict
    from video_depth_anything_torch.train.trainer import Trainer, make_optimizer

    world = init_distributed(device=args.device)
    mesh = create_grid(model=args.model_parallel) if world.size > 1 else None
    lead = world.rank == 0

    datasets = [get_dataset(name, root) for name, root in zip(args.dataset, args.root)]
    sampler = ClipSampler(datasets, clip_len=args.clip_len, batch_size=args.batch_size,
                          input_size=args.input_size,
                          augment=AugmentConfig() if args.augment else None)
    cfg = dataclasses.replace(get_model_config(args.encoder), remat_motion=args.remat_motion)
    model = VDAModel(args.encoder, device=world.device, cfg=cfg)
    if args.init_checkpoint:
        model.load_state_dict(load_init_checkpoint(args.init_checkpoint), strict=True)
    else:
        model.init_params(seed=0)
    trainer = Trainer(
        model.module,
        optimizer=make_optimizer(args.lr, train_encoder=args.train_encoder,
                                 warmup_steps=args.warmup_steps, decay_steps=args.decay_steps,
                                 accum_steps=args.accum_steps),
        mesh=mesh, tgm_weight=args.tgm_weight, compute_dtype=model.dtype,
        train_encoder=args.train_encoder, zero1=args.zero1,
    )
    os.makedirs(args.out, exist_ok=True)
    state_path = os.path.join(args.out, "state_latest.pt")
    if args.resume and os.path.exists(state_path):
        trainer.restore_state(state_path)
        if lead:
            print(f"resumed from {state_path} at step {trainer.global_step}")

    eval_batches = []
    if args.eval_every:
        # held-out clips: a differently seeded sampler, drawn once
        hold = iter(ClipSampler(datasets, clip_len=args.clip_len, batch_size=1,
                                input_size=args.input_size, seed=10_007))
        eval_batches = [next(hold) for _ in range(args.eval_clips)]

    def validate():
        """Scale/shift-aligned AbsRel and δ1 in disparity space (the SSI
        target space) over the held-out clips."""
        rels, d1s = [], []
        for b in eval_batches:
            with torch.inference_mode():
                x = torch.as_tensor(b["frames"]).to(model.device, model.dtype)
                pred = model.module(x).float().cpu().numpy()
            for i in range(pred.shape[0]):
                gt = b["disparity"][i]
                valid = (b["mask"][i] > 0) & (gt > 1e-6)
                s, t = compute_scale_and_shift(pred[i][valid], gt[valid])
                pa = np.maximum(pred[i] * s + t, 1e-6)
                rels.append(float(np.mean(np.abs(pa[valid] - gt[valid]) / gt[valid])))
                ratio = np.maximum(pa[valid] / gt[valid], gt[valid] / pa[valid])
                d1s.append(float(np.mean(ratio < 1.25)))
        return {"val_absrel_disp": round(float(np.mean(rels)), 5),
                "val_delta1_disp": round(float(np.mean(d1s)), 5)}

    log_path = os.path.join(args.out, "train_log.jsonl")
    t0 = time.time()
    # host-side clip sampling overlaps the device work in a background thread
    start_step = trainer.global_step
    before = kernel_launches()
    with Prefetcher(iter(sampler), depth=2) as it:
        for step in range(start_step + 1, args.steps + 1):
            metrics = trainer.step(next(it))
            is_log = step % args.log_every == 0 or step == 1
            is_eval = args.eval_every and step % args.eval_every == 0
            if is_log or is_eval:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=step, sps=round((step - start_step) / (time.time() - t0), 3))
                if is_eval:
                    m.update(validate())
                if lead:
                    line = json.dumps(m)
                    print(line)
                    with open(log_path, "a") as fh:
                        fh.write(line + "\n")
            if step % args.save_every == 0 or step == args.steps:
                trainer.save_state(state_path)
                path = os.path.join(args.out, f"step_{step:07d}.pth")
                weights = full_state_dict(model.module)
                if lead:
                    save_pth(path, weights)
                    print(f"saved {path} (+ resumable state_latest.pt)")
    if world.size > 1:
        after = kernel_launches()
        print(rank_line({k: after[k] - before[k] for k in after}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
