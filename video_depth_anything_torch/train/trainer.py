"""Training step for temporal fine-tuning (the JAX package's
``train/trainer.py``).

Loss = SSI + λ·TGM on disparity (``train.losses``), AdamW after a
global-norm clip, optionally under a linear-warmup + cosine-decay schedule
and with gradient accumulation.  With the frozen encoder (the default) the
encoder runs under ``torch.no_grad()``: no encoder backward, and its
parameters are not in the optimizer, as the JAX trainer passes them as a
non-differentiated constant and zeroes their updates.  The forward goes
through the port's kernel path on the card (every kernel is an autograd
Function there), the plain path on the CPU.  One process, one device:
``mesh`` and ``zero1`` are the multi-GPU work of ROADMAP Queue 1 item 12.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from video_depth_anything_torch.train.losses import video_depth_loss

_MULTI_GPU = "multi-GPU training (ROADMAP Queue 1 item 12) is not yet ported"


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

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        zeros = lambda: {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}  # noqa: E731
        state = {"count": 0, "mini_step": 0, "mu": zeros(), "nu": zeros()}
        if self.accum_steps > 1:
            state["acc"] = zeros()
        return state

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
               state: dict) -> bool:
        """Update ``params`` in place from ``grads`` (same names); returns
        whether this call applied an update (False on an accumulating
        micro-step)."""
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
        norm = global_norm(g)
        torch._foreach_mul_(g, torch.where(norm < self.clip_norm, torch.ones_like(norm),
                                           self.clip_norm / norm))
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
        p = [params[n] for n in names]
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
    gradients stay in the parameters' ``.grad`` until the next step."""

    def __init__(self, module, optimizer: Optional[AdamW] = None, mesh=None,
                 tgm_weight: float = 10.0, compute_dtype=torch.bfloat16,
                 remat_encoder: bool = True, train_encoder: bool = False, zero1: bool = False):
        if mesh is not None or zero1:
            raise NotImplementedError(_MULTI_GPU)
        self.module = module
        self.tx = optimizer or make_optimizer(train_encoder=train_encoder)
        if self.tx.train_encoder != train_encoder:
            raise ValueError("the optimizer's train_encoder must match the trainer's")
        self.tgm_weight = tgm_weight
        self.compute_dtype = compute_dtype
        # Whole-forward recompute only pays when gradients reach the
        # encoder; with it frozen the backward stops at the feature taps.
        self.remat = remat_encoder and train_encoder
        self.train_encoder = train_encoder
        self.params = {n: p for n, p in module.named_parameters() if self.tx.trainable(n)}
        self.opt_state = self.tx.init(self.params)
        self.global_step = 0

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    def _forward(self, frames: torch.Tensor) -> torch.Tensor:
        if self.remat:
            return checkpoint(self.module, frames, use_reentrant=False)
        return self.module(frames, freeze_encoder=not self.train_encoder)

    def step(self, batch) -> Dict[str, torch.Tensor]:
        dev = self.device
        frames = torch.as_tensor(batch["frames"]).to(dev, self.compute_dtype)
        disparity = torch.as_tensor(batch["disparity"]).to(dev, torch.float32)
        mask = torch.as_tensor(batch["mask"]).to(dev, torch.float32)
        for p in self.params.values():
            p.grad = None
        loss, metrics = video_depth_loss(self._forward(frames), disparity, mask, self.tgm_weight)
        loss.backward()
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                 for n, p in self.params.items()}
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(list(grads.values()))
        self.tx.update(self.params, grads, self.opt_state)
        self.global_step += 1
        return metrics

    # -- checkpoint / resume --------------------------------------------------

    def save_state(self, path: str) -> None:
        """Parameters (the reference-keyed state dict), optimizer state and
        step count, with ``torch.save``."""
        torch.save({"params": self.module.state_dict(), "opt_state": self.opt_state,
                    "step": self.global_step}, path)

    def restore_state(self, path: str) -> None:
        """Load a ``save_state`` file into the module and the trainer."""
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.module.load_state_dict(state["params"], strict=True)
        if set(state["opt_state"]["mu"]) != set(self.params):
            raise ValueError(f"{path}: optimizer state of other trainable parameters "
                             "(train_encoder differs?)")
        self.opt_state = state["opt_state"]
        self.global_step = int(state["step"])
