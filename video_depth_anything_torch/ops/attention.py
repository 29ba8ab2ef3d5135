"""Spatial multi-head attention with the JAX package's dispatch.

``multi_head_attention`` takes ``(B, S, H, D)`` tensors and an ``impl``
string of the JAX package's form (``ops/attention.py:46-76`` there):
``auto``, ``pallas`` or ``xla``, with an optional ``:fast`` suffix.
``auto`` sends every shape the JAX gate sends to a Pallas flash kernel to
Kernel A (``ops/flash_attention.py``, through ``FlashAttentionFn`` so that
it is differentiable), the no-max variant under ``:fast``; elsewhere, and
always under ``xla`` (which ignores ``:fast``, as in JAX), it runs the
plain dense attention (fp32 scores and softmax, output in the input
dtype).  ``pallas`` is ``auto`` on the CPU and refused on the card: in the
JAX package it also forces the Pallas temporal kernel at head widths that
Kernel B has no instantiation for.
"""

from __future__ import annotations

from typing import Tuple

import torch

from video_depth_anything_torch.ops.dispatch import kernels_enabled
from video_depth_anything_torch.ops.flash_attention import (
    FlashAttentionFn,
    flash_attention_plain,
    flash_gate,
)

IMPLS = ("auto", "pallas", "xla")


def parse_attn_impl(impl: str, device_type: str) -> Tuple[str, bool]:
    """``"auto:fast"`` → ``("auto", True)``: the base implementation and
    whether the no-max softmax is asked for.  ``pallas`` on a CUDA device
    raises ``NotImplementedError``."""
    base, _, variant = impl.partition(":")
    if base not in IMPLS or variant not in ("", "fast"):
        raise ValueError(f"attn_impl must be auto|pallas|xla with an optional :fast, got {impl!r}")
    if base == "pallas" and device_type == "cuda":
        raise NotImplementedError(
            "attn_impl 'pallas' is not ported to the card: it also forces the temporal kernel "
            "at head_dim 32/48/128, which Kernel B lacks (ROADMAP Queue 1 item 4); use 'auto'")
    return base, variant == "fast"


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         impl: str = "auto") -> torch.Tensor:
    """``(B, N, H, D)`` q, k, v → ``(B, N, H, D)``."""
    base, fast = parse_attn_impl(impl, q.device.type)
    scale = q.shape[-1] ** -0.5
    if base != "xla" and flash_gate(q.shape) and kernels_enabled():
        return FlashAttentionFn.apply(q, k, v, scale, fast)
    return flash_attention_plain(q, k, v, scale)
