"""Spatial multi-head attention with the JAX package's dispatch.

``multi_head_attention`` takes ``(B, S, H, D)`` tensors and an ``impl``
string of the JAX package's form (``ops/attention.py:46-76`` there):
``auto``, ``pallas`` or ``xla``, with an optional ``:fast`` suffix.
``auto`` sends every shape the JAX gate sends to a Pallas flash kernel to
Kernel A (``ops/flash_attention.py``, through ``FlashAttentionFn`` so that
it is differentiable), the no-max variant under ``:fast``; elsewhere, and
always under ``xla`` (which ignores ``:fast``, as in JAX), it runs the
plain dense attention (fp32 scores and softmax, output in the input
dtype).  ``pallas`` is ``auto`` here, as in JAX (``ops/attention.py:68-70``
there); in the motion modules it forces Kernel B wherever the JAX gate's
domain allows (``models/temporal.py``).
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
    whether the no-max softmax is asked for.  Every form runs on either
    ``device_type`` (``cpu`` or ``cuda``), ``pallas`` included."""
    base, _, variant = impl.partition(":")
    if base not in IMPLS or variant not in ("", "fast"):
        raise ValueError(f"attn_impl must be auto|pallas|xla with an optional :fast, got {impl!r}")
    return base, variant == "fast"


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         impl: str = "auto") -> torch.Tensor:
    """``(B, N, H, D)`` q, k, v → ``(B, N, H, D)``."""
    base, fast = parse_attn_impl(impl, q.device.type)
    scale = q.shape[-1] ** -0.5
    if base != "xla" and flash_gate(q.shape) and kernels_enabled():
        return FlashAttentionFn.apply(q, k, v, scale, fast)
    return flash_attention_plain(q, k, v, scale)
