"""Spatial multi-head attention with the JAX package's dispatch.

``multi_head_attention`` takes ``(B, S, H, D)`` tensors.  Where the JAX
gate sends the shape to a Pallas flash kernel, this sends it to Kernel A
(``ops/flash_attention.py``, through ``FlashAttentionFn`` so that it is
differentiable); elsewhere it runs the plain dense attention (fp32 scores
and softmax, output in the input dtype).
"""

from __future__ import annotations

import torch

from video_depth_anything_torch.ops.dispatch import kernels_enabled
from video_depth_anything_torch.ops.flash_attention import (
    FlashAttentionFn,
    flash_attention_plain,
    flash_gate,
)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``(B, N, H, D)`` q, k, v → ``(B, N, H, D)``."""
    scale = q.shape[-1] ** -0.5
    if flash_gate(q.shape) and kernels_enabled():
        return FlashAttentionFn.apply(q, k, v, scale)
    return flash_attention_plain(q, k, v, scale)
