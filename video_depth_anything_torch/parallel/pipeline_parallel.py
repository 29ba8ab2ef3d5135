"""Pipeline parallelism over the encoder's block chain, GPipe-style (the
JAX package's ``parallel/pipeline_parallel.py``).

The DINOv2 blocks are a sequential chain and frames are independent
through the encoder (temporal attention lives in the head only), so stage
``s`` of ``S`` (the model index of the grid) runs blocks ``[s·L/S,
(s+1)·L/S)`` and the window's ``B·T`` frames flow through in ``M``
microbatches: stage 0 embeds the frames and feeds microbatch ``j`` while
stage 1 runs microbatch ``j − 1``, and so on, with bubble fraction
``(S−1)/(M+S−1)``.  Activations hop stage to stage by point-to-point
``send``/``recv`` along a chain: every send has its receive, in the same
order on both sides, and no final hop wraps round as JAX's ring
``ppermute`` does.  Each of the four taps the DPT head takes is made by
one stage (``tap_placement``: its owning stage and its slot in that
stage's buffer) and broadcast from there to every rank of the group, which
then runs the final norm, the head and the upsample itself, so the depth
is on every rank, as JAX returns it replicated (and every rank launches
the head's kernels).

Each rank keeps the whole module; it runs only its stage's blocks.
JAX ``_pick_m``'s choice of ``M`` (``pick_microbatches``), the depth's
divisibility check (``check_stages``) and the tap placement are copies of
JAX's, warning included.
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from video_depth_anything_torch.ops.resize import bilinear_resize
from video_depth_anything_torch.parallel import comm
from video_depth_anything_torch.parallel.data_parallel import DataParallelVideoDepthPipeline
from video_depth_anything_torch.parallel.mesh import Grid, create_grid


def check_stages(depth: int, num_stages: int) -> int:
    """Blocks a stage (``stack_block_params``' check)."""
    if depth % num_stages:
        raise ValueError(f"encoder depth {depth} not divisible by {num_stages} stages")
    return depth // num_stages


def tap_placement(tap_idx: Sequence[int], per_stage: int, num_stages: int) -> Tuple[list, list, int]:
    """``(stage_of, slot_of, max_tps)``: each tap's owning stage, its slot
    in that stage's tap buffer and the most taps any stage owns (JAX
    ``_pp_encode_fn``)."""
    stage_of = [t // per_stage for t in tap_idx]
    slot_of = []
    counts = [0] * num_stages
    for s in stage_of:
        slot_of.append(counts[s])
        counts[s] += 1
    return stage_of, slot_of, max(counts)


def pick_microbatches(bt: int, num_stages: int, num_microbatches: Optional[int] = None) -> int:
    """Microbatch count: ``num_microbatches`` where given (it must divide
    ``bt``), else the divisor of ``bt`` nearest ``2·S`` (ties → larger),
    with JAX's warning when it leaves fewer microbatches than stages."""
    if num_microbatches is not None:
        m = int(num_microbatches)
        if bt % m:
            raise ValueError(f"microbatches {m} must divide B*T={bt}")
        return m
    target = 2 * num_stages
    divisors = [m for m in range(1, bt + 1) if bt % m == 0]
    m = min(divisors, key=lambda q: (abs(q - target), -q))
    if m < num_stages:
        warnings.warn(
            f"pipeline parallelism over {num_stages} stages with only {m} "
            f"microbatch(es) for B*T={bt}: bubble fraction "
            f"{(num_stages - 1) / (m + num_stages - 1):.0%} — pick a frame "
            f"count divisible into >= {num_stages} microbatches for real "
            f"pipelining",
            stacklevel=3,
        )
    return m


class PipelineParallelWindowRunner:
    """The window forward with the encoder staged over the grid's model
    group: ``infer_window(x)`` takes normalized ``(B, T, H, W, 3)`` frames
    and returns ``(B, T, H, W)`` depth on every rank of the group: the
    ``VDAModel.infer_window`` result, each block run on microbatches of the
    frames."""

    def __init__(self, model, num_stages: Optional[int] = None, grid: Optional[Grid] = None,
                 num_microbatches: Optional[int] = None):
        if grid is None:
            if not num_stages or num_stages < 2:
                raise ValueError("pipeline parallelism needs num_stages >= 2")
            grid = create_grid(model=num_stages)
        self.grid = grid
        self.model = model
        self.cfg = model.cfg
        self.S = grid.model
        self.Ls = check_stages(self.cfg.vit.depth, self.S)
        self.num_microbatches = num_microbatches
        self.tap_idx = tuple(int(i) for i in self.cfg.intermediate_layer_idx)
        self.stage = grid.model_index
        self._module = None
        self.refresh_params()

    def refresh_params(self) -> None:
        """Take this stage's blocks again when ``model.module`` was replaced
        since the last call (a checkpoint loaded into an already-built
        pipeline); loads into the same module are seen as they are."""
        if self.model.module is not self._module:
            self._module = self.model.module
            blocks = self._module.pretrained.blocks
            self.blocks = [blocks[i] for i in range(self.stage * self.Ls,
                                                      (self.stage + 1) * self.Ls)]

    @torch.inference_mode()
    def infer_window(self, frames, skip_tmp_block: bool = False) -> torch.Tensor:
        self.refresh_params()
        x = torch.as_tensor(frames).to(self.model.device, self.model.dtype)
        m = pick_microbatches(x.shape[0] * x.shape[1], self.S, self.num_microbatches)
        return self.forward(x, m, skip_tmp_block)

    def forward(self, x: torch.Tensor, M: int, skip_tmp_block: bool = False) -> torch.Tensor:
        module = self._module
        vit = module.pretrained
        b, t, h, w, _ = x.shape
        ph, pw = module._check_hw(h, w)
        bt, n1, d = b * t, ph * pw + 1, vit.cfg.embed_dim
        m = bt // M
        ranks = self.grid.model_group.ranks
        s = self.stage
        stage_of, slot_of, max_tps = tap_placement(self.tap_idx, self.Ls, self.S)
        # this stage's taps: slot -> the M microbatch outputs
        buf: List[List[torch.Tensor]] = [[] for _ in range(max_tps)]
        tokens = vit.embed(x.reshape(bt, h, w, 3)) if s == 0 else None
        for j in range(M):
            if s == 0:
                xm = tokens[j * m:(j + 1) * m]
            else:
                xm = comm.recv_(torch.empty((m, n1, d), dtype=x.dtype, device=x.device),
                                ranks[s - 1])
            for i, blk in enumerate(self.blocks):
                xm = blk(xm)
                g = s * self.Ls + i
                for k, tap in enumerate(self.tap_idx):
                    if tap == g:
                        buf[slot_of[k]].append(xm)
            if s < self.S - 1:
                comm.send(xm, ranks[s + 1])
        feats = []
        for k in range(len(self.tap_idx)):
            owner = stage_of[k]
            if owner == s:
                tap = torch.cat(buf[slot_of[k]])
            else:
                tap = torch.empty((bt, n1, d), dtype=x.dtype, device=x.device)
            comm.broadcast_(tap, ranks[owner], self.grid.model_group)
            feats.append(vit.norm(tap)[:, 1:])
        depth = module.head(tuple(feats), b, ph, pw, skip_tmp_block).to(x.dtype)
        return bilinear_resize(depth, h, w).reshape(b, t, h, w)


class PipelineParallelVideoDepthPipeline(DataParallelVideoDepthPipeline):
    """``VideoDepthPipeline`` with the window forward staged over
    ``pipeline_parallel`` ranks: the same preprocessing, window batching,
    stitching and outputs (``run --pipeline_parallel N``).  A world of more
    than N ranks splits the windows over its data groups as the
    data-parallel pipeline does."""

    def __init__(self, model, pipeline_parallel: int = 2, num_microbatches: Optional[int] = None,
                 grid: Optional[Grid] = None, **kwargs):
        if grid is None:
            if pipeline_parallel < 2:
                raise ValueError("pipeline parallelism needs num_stages >= 2")
            grid = create_grid(model=pipeline_parallel)
        super().__init__(model, grid=grid, **kwargs)
        self._pp_runner = PipelineParallelWindowRunner(model, grid=grid,
                                                       num_microbatches=num_microbatches)

    def _prepare_model(self) -> None:
        """The stages split the blocks, not the weights."""

    def _window_forward(self, frames: np.ndarray, skip_tmp_block: bool):
        return self._pp_runner.infer_window(frames, skip_tmp_block=skip_tmp_block)
