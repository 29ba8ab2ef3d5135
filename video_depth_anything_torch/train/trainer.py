"""Training step for temporal fine-tuning (the JAX package's
``train/trainer.py``).

Loss = SSI + λ·TGM on disparity (``train.losses``), AdamW after a
global-norm clip, optionally under a linear-warmup + cosine-decay schedule
and with gradient accumulation.  With the frozen encoder (the default) the
encoder runs under ``torch.no_grad()``: no encoder backward, and its
parameters are not in the optimizer, as the JAX trainer passes them as a
non-differentiated constant and zeroes their updates.  The forward goes
through the port's kernel path on the card (every kernel is an autograd
Function there), the plain path on the CPU.

Across GPUs (``mesh``, a ``parallel/mesh.Grid``): the encoder is split
over each model group (``shard_module``); each data rank takes its slice
of the one global batch that every rank draws; each rank's loss is its
share of the global loss (the mask-weight denominators summed over the
data group, ``train/losses.py``), so the gradients summed over the data
group are those of the single-process step on the global batch, before
the global-norm clip.  ``zero1`` shards AdamW's moments over the data
group on the dimension ``zero1_spec`` picks (JAX ``_zero1_spec``, copied);
each rank updates its shard and the parameters are all-gathered.  Rank 0
writes the checkpoints, with every shard and moment gathered whole, so a
state saved at one world size resumes at any other.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from video_depth_anything_torch.parallel import comm
from video_depth_anything_torch.parallel import mesh as tp
from video_depth_anything_torch.train.losses import video_depth_loss


def zero1_spec(spec: tuple, shape, data: int) -> tuple:
    """Add ``'data'`` to the first dimension a leaf can shard: not sharded
    by tensor parallelism, divisible by the data group's size (JAX
    ``_zero1_spec`` over a tuple of axis names).  Unchanged when none
    qualifies (scalars, small or odd leaves stay replicated)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (p, s) in enumerate(zip(parts, shape)):
        if p is None and s >= data and s % data == 0:
            parts[i] = "data"
            return tuple(parts)
    return tuple(spec)


def _part(t: torch.Tensor, view):
    """``t``'s ZeRO-1 shard: ``view`` is ``(dim, start, length)`` or None."""
    return t if view is None else t.narrow(*view)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax's ``chain(clip_by_global_norm, adamw)``, under ``MultiSteps``
    when ``accum_steps > 1``, on a dict of named parameters.

    * The clip is optax's: ``g`` when ``‖g‖ < clip_norm``, else
      ``g · clip_norm / ‖g‖`` (no epsilon on the norm).
    * Adam (b1 0.9, b2 0.999, eps 1e-8 outside the root) with decoupled
      weight decay on every trainable tensor; the step size comes from
      ``learning_rate`` at the count of updates made so far.
    * Accumulation averages the micro-batch gradients (optax's running
      mean) and updates on every ``accum_steps``-th call only; the schedule
      and the bias correction count updates, not micro-steps.
    * With ``train_encoder`` False, ``pretrained.*`` is not trainable: no
      state, no update, no decay (optax ``set_to_zero``)."""

    learning_rate: float = 1e-5
    weight_decay: float = 1e-2
    train_encoder: bool = False
    clip_norm: float = 1.0
    warmup_steps: int = 0
    decay_steps: int = 0
    accum_steps: int = 1

    B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adamw's defaults

    def __post_init__(self):
        if self.decay_steps and self.decay_steps <= max(1, self.warmup_steps):
            raise ValueError("decay_steps is the whole horizon and must exceed warmup_steps")

    def trainable(self, name: str) -> bool:
        return self.train_encoder or not name.startswith("pretrained.")

    def lr(self, count: int) -> float:
        """optax ``warmup_cosine_decay_schedule(0, lr, max(1, warmup),
        decay_steps or 1e9, 0 if decay_steps else lr)`` when either is set;
        the constant ``learning_rate`` otherwise."""
        if not (self.warmup_steps or self.decay_steps):
            return self.learning_rate
        warmup = max(1, self.warmup_steps)
        if count < warmup:
            return self.learning_rate * count / warmup
        horizon = (self.decay_steps or 10**9) - warmup
        alpha = 0.0 if self.decay_steps else 1.0
        frac = min(count - warmup, horizon) / horizon
        return self.learning_rate * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac)) + alpha)

    def init(self, params: Dict[str, torch.Tensor], views: Optional[dict] = None) -> dict:
        """Zero state; with ``views`` (name → ZeRO-1 ``(dim, start,
        length)``) the moments are those shards."""
        views = views or {}

        def zeros(part: bool):
            return {n: torch.zeros_like(_part(p, views.get(n)) if part else p,
                                        dtype=torch.float32) for n, p in params.items()}
        state = {"count": 0, "mini_step": 0, "mu": zeros(True), "nu": zeros(True)}
        if self.accum_steps > 1:
            state["acc"] = zeros(False)
        return state

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
               state: dict, views: Optional[dict] = None, norm_fn=None) -> bool:
        """Update ``params`` in place from ``grads`` (same names); returns
        whether this call applied an update (False on an accumulating
        micro-step).  ``views``: update only each parameter's ZeRO-1 shard
        (the caller gathers them); ``norm_fn(names, grads)``: the global
        norm where parameters are sharded (``global_norm`` otherwise)."""
        names = list(params)
        g = [grads[n].float() for n in names]
        if self.accum_steps > 1:
            acc = [state["acc"][n] for n in names]
            n_acc = state["mini_step"]
            for a, gi in zip(acc, g):
                a.add_((gi - a) / (n_acc + 1))
            if n_acc + 1 < self.accum_steps:
                state["mini_step"] = n_acc + 1
                return False
            g = [a.clone() for a in acc]
            for a in acc:
                a.zero_()
            state["mini_step"] = 0
        else:
            g = [gi.clone() for gi in g]
        norm = global_norm(g) if norm_fn is None else norm_fn(names, g)
        torch._foreach_mul_(g, torch.where(norm < self.clip_norm, torch.ones_like(norm),
                                           self.clip_norm / norm))
        views = views or {}
        g = [_part(gi, views.get(n)) for n, gi in zip(names, g)]
        mu = [state["mu"][n] for n in names]
        nu = [state["nu"][n] for n in names]
        torch._foreach_mul_(mu, self.B1)
        torch._foreach_add_(mu, g, alpha=1 - self.B1)
        torch._foreach_mul_(nu, self.B2)
        torch._foreach_addcmul_(nu, g, g, value=1 - self.B2)
        count = state["count"]
        # optax's bias corrections, 1 - b**count, in fp32
        bc1, bc2 = (float(1 - np.float32(b) ** np.float32(count + 1)) for b in (self.B1, self.B2))
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.EPS)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, den)
        p = [_part(params[n], views.get(n)) for n in names]
        torch._foreach_add_(upd, p, alpha=self.weight_decay)
        torch._foreach_add_(p, upd, alpha=-self.lr(count))
        state["count"] = count + 1
        return True


def make_optimizer(learning_rate: float = 1e-5, weight_decay: float = 1e-2,
                   train_encoder: bool = False, clip_norm: float = 1.0, warmup_steps: int = 0,
                   decay_steps: int = 0, accum_steps: int = 1) -> AdamW:
    """The JAX ``make_optimizer`` with the same arguments and defaults."""
    return AdamW(learning_rate, weight_decay, train_encoder, clip_norm, warmup_steps,
                 decay_steps, accum_steps)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, fp32 (optax
    ``global_norm``)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm([t.float() for t in tensors])))


class Trainer:
    """``step(batch)`` trains ``module`` (a ``VideoDepthAnything``) on one
    batch: ``frames (B, T, H, W, 3)`` normalised, ``disparity`` and
    ``mask (B, T, H, W)``, as numpy arrays or tensors.  Returns the fp32
    0-d tensors ``loss``, ``ssi``, ``tgm`` and ``grad_norm`` (the norm of
    the trainable gradients before the clip).  The optimizer state and the
    count of steps (``global_step``) live on the trainer; the step's
    gradients stay in the parameters' ``.grad`` until the next step.
    ``mesh`` (a ``parallel/mesh.Grid``) and ``zero1``: the module
    docstring; with ``mesh`` the batch is the global one and the metrics
    are the global batch's on every rank."""

    def __init__(self, module, optimizer: Optional[AdamW] = None, mesh=None,
                 tgm_weight: float = 10.0, compute_dtype=torch.bfloat16,
                 remat_encoder: bool = True, train_encoder: bool = False, zero1: bool = False):
        self.module = module
        self.tx = optimizer or make_optimizer(train_encoder=train_encoder)
        if self.tx.train_encoder != train_encoder:
            raise ValueError("the optimizer's train_encoder must match the trainer's")
        self.grid = mesh
        if mesh is not None:
            tp.shard_module(module, mesh)
        self.tgm_weight = tgm_weight
        self.compute_dtype = compute_dtype
        # Whole-forward recompute only pays when gradients reach the
        # encoder; with it frozen the backward stops at the feature taps.
        self.remat = remat_encoder and train_encoder
        self.train_encoder = train_encoder
        self.params = {n: p for n, p in module.named_parameters() if self.tx.trainable(n)}
        self.shards = {n: sh for n, sh in tp.shards(module).items() if n in self.params}
        self.zero1 = bool(zero1) and mesh is not None and mesh.data > 1
        self.views = self._zero1_views() if self.zero1 else {}
        self.opt_state = self.tx.init(self.params, self.views)
        self.global_step = 0

    def _zero1_views(self) -> dict:
        """Name → this data rank's ``(dim, start, length)`` of the leaf,
        on the dimension ``zero1_spec`` picks from its whole shape."""
        g = self.grid
        views = {}
        for n, p in self.params.items():
            shape = list(p.shape)
            spec = [None] * p.dim()
            if n in self.shards:
                dim = self.shards[n].dim if p.dim() > 1 else 0
                shape[dim], spec[dim] = self.shards[n].full, "model"
            spec = zero1_spec(tuple(spec), shape, g.data)
            if "data" in spec:
                dim = spec.index("data")
                size = p.shape[dim] // g.data
                views[n] = (dim, g.data_index * size, size)
        return views

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    def _forward(self, frames: torch.Tensor) -> torch.Tensor:
        if self.remat:
            return checkpoint(self.module, frames, use_reentrant=False)
        return self.module(frames, freeze_encoder=not self.train_encoder)

    def _norm(self, names, grads) -> torch.Tensor:
        """The global norm of whole gradients: the squares of tensor-parallel
        shards summed over the model group, the replicated ones once."""
        sq = [t.float().square().sum() for t in grads]
        rep = sum((q for n, q in zip(names, sq) if n not in self.shards), torch.zeros(()))
        part = sum((q for n, q in zip(names, sq) if n in self.shards), torch.zeros(()))
        rep, part = rep.to(self.device), part.to(self.device)
        if self.grid is not None:
            comm.all_reduce_(part, self.grid.model_group)
        return torch.sqrt(rep + part)

    def _local_batch(self, batch):
        """This data rank's rows of the global batch."""
        if self.grid is None or self.grid.data == 1:
            return batch
        b = len(batch["frames"])
        if b < self.grid.data:
            raise ValueError(f"a batch of {b} clips cannot split over {self.grid.data} data ranks")
        rows = np.array_split(np.arange(b), self.grid.data)[self.grid.data_index]
        return {k: batch[k][int(rows[0]):int(rows[-1]) + 1] for k in ("frames", "disparity", "mask")}

    def step(self, batch) -> Dict[str, torch.Tensor]:
        dev = self.device
        batch = self._local_batch(batch)
        frames = torch.as_tensor(batch["frames"]).to(dev, self.compute_dtype)
        disparity = torch.as_tensor(batch["disparity"]).to(dev, torch.float32)
        mask = torch.as_tensor(batch["mask"]).to(dev, torch.float32)
        for p in self.params.values():
            p.grad = None
        data = self.grid.data_group if self.grid is not None else None
        total = None if data is None or data.size == 1 else \
            (lambda den: comm.all_reduce_(den.detach().clone(), data))
        loss, metrics = video_depth_loss(self._forward(frames), disparity, mask, self.tgm_weight,
                                         total)
        loss.backward()
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                 for n, p in self.params.items()}
        metrics = {k: v.detach() for k, v in metrics.items()}
        if total is not None:
            flat = torch.cat([g.reshape(-1).float() for g in grads.values()])
            comm.all_reduce_(flat, data)
            for g, piece in zip(grads.values(), flat.split([g.numel() for g in grads.values()])):
                g.copy_(piece.view_as(g))
            metrics = {k: comm.all_reduce_(v.clone(), data) for k, v in metrics.items()}
        # tensor-parallel shards need their squares summed over the model group
        norm_fn = self._norm if self.shards else None
        g = list(grads.values())
        metrics["grad_norm"] = global_norm(g) if norm_fn is None else norm_fn(list(grads), g)
        applied = self.tx.update(self.params, grads, self.opt_state, self.views, norm_fn)
        if applied and self.views:
            self._gather_params()
        self.global_step += 1
        return metrics

    @torch.no_grad()
    def _gather_params(self) -> None:
        """Each ZeRO-1 shard's update onto every rank of the data group."""
        for n, (dim, _, size) in self.views.items():
            p = self.params[n]
            pieces = comm.all_gather(p.narrow(dim, self.grid.data_index * size, size).contiguous(),
                                     self.grid.data_group)
            p.copy_(torch.cat(pieces, dim=dim))

    # -- checkpoint / resume --------------------------------------------------

    def _whole(self, n: str, t: torch.Tensor) -> torch.Tensor:
        """A parameter-shaped tensor of this rank, gathered whole."""
        return tp.full_tensor(self.shards[n], t) if n in self.shards else t

    def _whole_moment(self, n: str, t: torch.Tensor) -> torch.Tensor:
        if n in self.views:
            t = torch.cat(comm.all_gather(t.contiguous(), self.grid.data_group),
                          dim=self.views[n][0])
        return self._whole(n, t)

    def _gathered_opt_state(self) -> dict:
        st = self.opt_state
        out = {k: v for k, v in st.items() if k not in ("mu", "nu", "acc")}
        for k in ("mu", "nu"):
            out[k] = {n: self._whole_moment(n, t) for n, t in st[k].items()}
        if "acc" in st:
            out["acc"] = {n: self._whole(n, t) for n, t in st["acc"].items()}
        return out

    def save_state(self, path: str) -> None:
        """Parameters (the reference-keyed state dict), optimizer state and
        step count, with ``torch.save``; every shard and moment gathered
        whole, written by rank 0 (every rank must call it)."""
        params = tp.full_state_dict(self.module) if self.grid is not None \
            else self.module.state_dict()
        opt_state = self._gathered_opt_state()
        if comm.world().rank == 0:
            torch.save({"params": params, "opt_state": opt_state, "step": self.global_step},
                       path)
        comm.barrier()

    def restore_state(self, path: str) -> None:
        """Load a ``save_state`` file (of any world size) into the module
        and the trainer."""
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.module.load_state_dict(tp.local_state_dict(self.module, state["params"]),
                                    strict=True)
        opt = state["opt_state"]
        if set(opt["mu"]) != set(self.params):
            raise ValueError(f"{path}: optimizer state of other trainable parameters "
                             "(train_encoder differs?)")

        def local(n, t, moment):
            if n in self.shards:
                t = tp.local_tensor(self.shards[n], t)
            return _part(t, self.views.get(n)).contiguous() if moment else t

        for k in ("mu", "nu"):
            opt[k] = {n: local(n, t, True) for n, t in opt[k].items()}
        if "acc" in opt:
            opt["acc"] = {n: local(n, t, False) for n, t in opt["acc"].items()}
        self.opt_state = opt
        self.global_step = int(state["step"])
