"""Spawned gloo ranks for the ``test_torch_parallel_*`` files.

``spawn(fn, world_size, tmp_path, *args)`` runs ``fn(rank, *args)`` in
``world_size`` fresh processes on the CPU, each on one torch thread, over a
gloo group started from a ``FileStore`` in ``tmp_path`` (no TCP port, so
that test workers never collide).  A rank that raises fails the call and
its siblings are killed; so are all ranks past ``timeout`` seconds.  The
rank functions below import torch and the port only (no JAX): they write
their results as ``.npy``/``.pt`` files under the test's directory, which
the test then holds against the single-process run and JAX.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch


def spawn(fn, world_size: int, tmp_path, *args, timeout: float = 150.0) -> None:
    import torch.multiprocessing as mp

    store = os.path.join(str(tmp_path), f"store_{fn.__name__}_{world_size}_{time.time_ns()}")
    ctx = mp.start_processes(_entry, args=(fn, world_size, store, args), nprocs=world_size,
                             join=False, start_method="spawn")
    deadline = time.time() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.time() > deadline:
                raise TimeoutError(f"{fn.__name__} at world size {world_size} passed "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def _entry(rank: int, fn, world_size: int, store: str, args) -> None:
    torch.set_num_threads(1)
    os.environ["VDA_NATIVE_PREPROC"] = "0"
    from video_depth_anything_torch.parallel import comm

    comm.init_distributed(init_method=f"file://{store}", rank=rank, world_size=world_size,
                          device="cpu", timeout_s=120)
    try:
        fn(rank, *args)
    finally:
        comm.shutdown()


def port_config(encoder: str = "vits", depth: int = 4):
    """The port's half of ``torch_port_helpers.configs``."""
    from video_depth_anything_torch import config as tcfg

    taps = tuple(int(round(i * (depth - 1) / 3)) for i in range(4))
    cfg = tcfg.get_model_config(encoder)
    return dataclasses.replace(cfg, vit=dataclasses.replace(cfg.vit, depth=depth),
                               intermediate_layer_idx=taps)


def load_model(encoder: str, depth: int, state_path: str):
    """The port's fp32 CPU model of ``model_pair`` from its saved state."""
    from video_depth_anything_torch.models.vda import VDAModel

    model = VDAModel(cfg=port_config(encoder, depth), device="cpu", dtype=torch.float32)
    model.load_state_dict(torch.load(state_path, weights_only=True), strict=True)
    return model


def _save(out_dir: str, name: str, rank: int, value) -> None:
    np.save(os.path.join(out_dir, f"{name}.rank{rank}.npy"), np.asarray(value))


def load(out_dir, name: str, rank: int) -> np.ndarray:
    return np.load(os.path.join(str(out_dir), f"{name}.rank{rank}.npy"))


def split_sums(module, n: int):
    """``module`` (in place) with each row-parallel product of ``n``-rank
    tensor parallelism computed as the ranks compute it, in one process:
    the partial products over each rank's heads (``attn.proj``) or hidden
    block (``mlp.fc2``), summed in rank order, then the bias.  Its distance
    from the unsplit forward is the fp32 reassociation that any split of
    those sums costs, which the noised weights amplify through the model."""
    import torch.nn.functional as F

    from video_depth_anything_torch.parallel.mesh import block_split, head_cols, head_split

    for blk in module.pretrained.blocks:
        attn = blk.attn
        heads = [head_cols(head_split(attn.num_heads, n, j), attn.head_dim) for j in range(n)]
        hidden = [block_split(blk.mlp.fc2.weight.shape[1], n, j) for j in range(n)]
        for lin, blocks in ((attn.proj, heads), (blk.mlp.fc2, hidden)):
            def forward(x, lin=lin, blocks=blocks):
                y = None
                for ix in blocks:
                    ix = torch.as_tensor(ix)
                    part = F.linear(x[..., ix], lin.weight[:, ix].to(x.dtype))
                    y = part if y is None else y + part
                return y + lin.bias.to(y.dtype)
            lin.forward = forward
    return module


def floor_tol(split, single, factor: float = 4.0, least: float = 1e-5) -> float:
    """The bound of a sharded result against the single-process one: 1e-5,
    or ``factor`` times the split sums' own distance from it where the
    model amplifies that reassociation past 1e-5."""
    diff, scale = float(np.abs(split - single).max()), float(np.abs(single).max())
    return max(least, factor * diff / scale) if scale else (least if diff == 0 else np.inf)


# -- tensor parallelism ------------------------------------------------------------


def tp_window(rank, encoder, depth, state_path, frames_path, out_dir) -> None:
    """The TP window forward over the whole world (``model_parallel`` = the
    world size), then the same with two mutants of the split: each rank's
    qkv rows a contiguous block of the fused weight (rank 0 of two takes all
    of q and part of k), and the row-parallel bias added on every rank
    before the sum.  Also whether the shards gather back to the whole
    state."""
    from video_depth_anything_torch.parallel import comm, mesh

    x = np.load(frames_path)
    grid = mesh.create_grid(model=torch.distributed.get_world_size())
    for mutant in (None, "contiguous_qkv", "bias_every_rank"):
        model = load_model(encoder, depth, state_path)
        whole = {k: v.clone() for k, v in model.module.state_dict().items()}
        mesh.shard_module(model.module, grid)
        for i, blk in enumerate(model.module.pretrained.blocks):
            if mutant == "contiguous_qkv":
                qkv = blk.attn.qkv
                sizes = [len(ix) for ix in qkv.indices]
                start = sum(sizes[:grid.model_index])
                rows = torch.arange(start, start + sizes[grid.model_index])
                with torch.no_grad():
                    qkv.weight.copy_(whole[f"pretrained.blocks.{i}.attn.qkv.weight"][rows])
                    qkv.bias.copy_(whole[f"pretrained.blocks.{i}.attn.qkv.bias"][rows])
            elif mutant == "bias_every_rank":
                for lin in (blk.attn.proj, blk.mlp.fc2):
                    def forward(x, lin=lin):
                        y = torch.nn.functional.linear(x, lin.weight, lin.bias)
                        return comm.reduce_from_group(y, lin.group)
                    lin.forward = forward
        _save(out_dir, f"tp_{mutant}", rank, model.infer_window(x).float().numpy())
        if mutant is None:
            full = mesh.full_state_dict(model.module)
            _save(out_dir, "tp_state_roundtrip", rank,
                  all(torch.equal(full[k], whole[k]) for k in whole))
            _save(out_dir, "tp_heads", rank,
                  [blk.attn.num_heads for blk in model.module.pretrained.blocks])


# -- pipeline parallelism ---------------------------------------------------------


def pp_window(rank, encoder, depth, state_path, frames_path, out_dir, video_path,
              state2_path) -> None:
    """The PP window forward over the whole world (``S`` = world size) with
    the automatic microbatch count and with 2, the pipeline-parallel video
    pipeline on a clip at input size 28, then the runner again after
    ``model.module`` was replaced by a module of other weights
    (``refresh_params``)."""
    from video_depth_anything_torch.io.video import read_video_frames
    from video_depth_anything_torch.parallel.pipeline_parallel import (
        PipelineParallelVideoDepthPipeline,
        PipelineParallelWindowRunner,
    )

    s = torch.distributed.get_world_size()
    model = load_model(encoder, depth, state_path)
    x = np.load(frames_path)
    for m in (None, 2):
        runner = PipelineParallelWindowRunner(model, num_stages=s, num_microbatches=m)
        _save(out_dir, f"pp_{m}", rank, runner.infer_window(x).float().numpy())
    frames, _ = read_video_frames(video_path)
    pipe = PipelineParallelVideoDepthPipeline(model, pipeline_parallel=s, input_size=28)
    _save(out_dir, "pp_video", rank, pipe.infer_video_depth(frames)[0])
    model.module = load_model(encoder, depth, state2_path).module
    _save(out_dir, "pp_refreshed", rank, runner.infer_window(x).float().numpy())


def pp_emulated(model, x: np.ndarray, m: int) -> np.ndarray:
    """What the stages compute, in one process: the encoder's blocks on
    microbatches of ``m`` microbatches' frames, the taps concatenated, the
    head on the whole window."""
    from video_depth_anything_torch.ops.resize import bilinear_resize

    module = model.module
    vit = module.pretrained
    with torch.inference_mode():
        xt = torch.as_tensor(x)
        b, t, h, w, _ = xt.shape
        ph, pw = h // 14, w // 14
        tokens = vit.embed(xt.reshape(b * t, h, w, 3))
        taps = {i: [] for i in module.cfg.intermediate_layer_idx}
        for chunk in tokens.chunk(m):
            for i, blk in enumerate(vit.blocks):
                chunk = blk(chunk)
                if i in taps:
                    taps[i].append(chunk)
        feats = tuple(vit.norm(torch.cat(taps[i]))[:, 1:] for i in module.cfg.intermediate_layer_idx)
        depth = module.head(feats, b, ph, pw, False).to(xt.dtype)
        return bilinear_resize(depth, h, w).reshape(b, t, h, w).numpy()


# -- data-parallel and multi-host pipelines -----------------------------------------


def dp_video(rank, encoder, depth, state_path, video_path, out_dir, window_batch) -> None:
    """``DataParallelVideoDepthPipeline`` on a clip at input size 28, over
    frames in memory (``infer_video_depth``) and over ranged decodes of the
    file (``infer_frame_range``, the multi-host CLI's path); both record
    the frame range this rank read."""
    from video_depth_anything_torch.io.video import (
        count_video_frames,
        read_video_frame_range,
        read_video_frames,
    )
    from video_depth_anything_torch.parallel.data_parallel import DataParallelVideoDepthPipeline

    model = load_model(encoder, depth, state_path)
    frames, _ = read_video_frames(video_path)
    dp = DataParallelVideoDepthPipeline(model, input_size=28, window_batch=window_batch)
    _save(out_dir, "dp", rank, dp.infer_video_depth(frames)[0])
    _save(out_dir, "dp_decoded", rank, dp.decoded)
    n, _ = count_video_frames(video_path)
    mh = DataParallelVideoDepthPipeline(model, input_size=28, window_batch=window_batch)
    depth_mh, _ = mh.infer_frame_range(n, lambda a, b: read_video_frame_range(video_path, a, b))
    _save(out_dir, "mh", rank, depth_mh)
    _save(out_dir, "mh_decoded", rank, mh.decoded)


# -- tensor-parallel streaming ------------------------------------------------------


def tp_streaming(rank, encoder, depth, state_path, frames_path, out_dir) -> None:
    """Feature-cache and KV-cache streaming with the encoder split over the
    whole world (``model_parallel`` = world size)."""
    from video_depth_anything_torch.inference.kv_streaming import KVStreamingPipeline
    from video_depth_anything_torch.inference.streaming import StreamingDepthPipeline

    n = torch.distributed.get_world_size()
    frames = np.load(frames_path)
    model = load_model(encoder, depth, state_path)
    fc = StreamingDepthPipeline(model, input_size=28, inference_length=6, keyframe_list=(2,),
                                chunk_size=2, model_parallel=n)
    _save(out_dir, "stream_fc", rank, fc.infer(frames)[0])
    kv = KVStreamingPipeline(model, input_size=28, inference_length=6, stream_chunk=2,
                             model_parallel=n)
    _save(out_dir, "stream_kv", rank, kv.infer(frames)[0])


# -- training ------------------------------------------------------------------------


def train_steps(rank, encoder, depth, state_path, batch_path, out_dir, model_parallel,
                cases) -> None:
    """For each ``(zero1, train_encoder)`` of ``cases``: two Trainer steps
    on the global batch over a ``data × model`` grid, the metrics of both,
    the gradients of the first (gathered whole), and a checkpoint after the
    second (written by rank 0)."""
    from video_depth_anything_torch.parallel import mesh
    from video_depth_anything_torch.train.trainer import Trainer, make_optimizer

    batch = dict(np.load(batch_path))
    grid = mesh.create_grid(model=model_parallel)
    for zero1, train_encoder in cases:
        model = load_model(encoder, depth, state_path)
        trainer = Trainer(model.module, make_optimizer(1e-3, train_encoder=train_encoder),
                          mesh=grid, compute_dtype=torch.float32, train_encoder=train_encoder,
                          zero1=zero1)
        tag = train_tag(model_parallel, zero1, train_encoder)
        metrics = [trainer.step(batch)]
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                 for n, p in trainer.params.items()}
        grads = {n: mesh.full_tensor(trainer.shards[n], g) if n in trainer.shards else g
                 for n, g in grads.items()}
        if rank == 0:
            torch.save(grads, os.path.join(out_dir, f"{tag}_grads.pt"))
        metrics.append(trainer.step(batch))
        _save(out_dir, f"{tag}_metrics", rank,
              [[float(m[k]) for k in ("loss", "ssi", "tgm", "grad_norm")] for m in metrics])
        _save(out_dir, f"{tag}_views", rank, sorted(trainer.views))
        trainer.save_state(os.path.join(out_dir, f"{tag}.pt"))


def split_batch_grads(module, batch, n: int, train_encoder: bool, dtype=torch.float32):
    """What ``n`` data ranks compute, in one process: each rank's clips
    forward and backward alone, its loss the share of the global one (the
    mask-weight denominators of the whole batch), the gradients summed in
    rank order.  Returns (loss, grads by name)."""
    from video_depth_anything_torch.train.losses import video_depth_loss

    mask = torch.as_tensor(batch["mask"])
    dens = [mask.sum(), (mask[:, 1:] * mask[:, :-1]).sum()]
    params = {k: p for k, p in module.named_parameters()
              if train_encoder or not k.startswith("pretrained.")}
    total, loss = {}, 0.0
    for rows in np.array_split(np.arange(len(mask)), n):
        sl = slice(int(rows[0]), int(rows[-1]) + 1)
        for p in params.values():
            p.grad = None
        pred = module(torch.as_tensor(batch["frames"][sl]).to(dtype),
                      freeze_encoder=not train_encoder)
        queue = list(dens)
        part, _ = video_depth_loss(pred, torch.as_tensor(batch["disparity"][sl]), mask[sl],
                                   total=lambda den: queue.pop(0))
        part.backward()
        loss = loss + float(part.detach())
        for k, p in params.items():
            g = torch.zeros_like(p) if p.grad is None else p.grad
            total[k] = g.clone() if k not in total else total[k] + g
    return loss, total


def train_tag(model_parallel: int, zero1: bool, train_encoder: bool) -> str:
    return f"train_m{model_parallel}_z{int(zero1)}_e{int(train_encoder)}"


# -- the CLIs -------------------------------------------------------------------------


CLI_RUNS = {  # output directory: the run CLI's flags past the common ones
    "dp": ["--data_parallel"],
    "pp": ["--pipeline_parallel", "2", "--pp_microbatches", "4"],
    "tp": ["--model_parallel", "2"],
    "tp_kv": ["--model_parallel", "2", "--process_single_image", "--kv_cache",
              "--inference_length", "6"],
}


def cli_args(video: str, out: str, extra) -> list:
    return ["--input_video", video, "--output_dir", out, "--device", "cpu", "--random_init",
            "--fp32", "--input_size", "28", "--save_npz"] + list(extra)


def eval_args(root: str, csv: str, extra) -> list:
    return ["--dataset", "sintel", "--root", root, "--csv", csv, "--device", "cpu",
            "--random_init", "--fp32", "--input_size", "28", "--no_tae"] + list(extra)


def cli_ranks(rank, video, sintel_root, out_dir) -> None:
    """The run CLI in each mode of ``CLI_RUNS`` and the eval CLI with
    ``--data_parallel``, called in-process on every rank of the started
    world (the CLIs find it started)."""
    from video_depth_anything_torch import eval as t_eval
    from video_depth_anything_torch import run

    for name, extra in CLI_RUNS.items():
        assert run.main(cli_args(video, os.path.join(out_dir, name), extra)) == 0
    assert t_eval.main(eval_args(sintel_root, os.path.join(out_dir, "eval.csv"),
                                 ["--data_parallel"])) == 0
