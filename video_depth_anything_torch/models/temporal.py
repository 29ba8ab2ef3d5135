"""Temporal ("motion") modules (the JAX package's ``models/temporal.py``).

GroupNorm(32) → proj_in → [2 × (LN → +APE → attention over the frame axis
per location → residual), LN → GEGLU FF → residual] → proj_out → + input,
on ``(B, T, H, W, C)`` maps.  Parameter names are the reference torch keys
(``temporal_transformer.transformer_blocks.0.attention_blocks.0.to_q``, …).

Dispatch follows the JAX package: a module that the JAX gate sends to the
fused Pallas module goes to Kernel C (``ops/motion_module.py``); otherwise
each attention whose shape the JAX gate sends to the Pallas temporal core
goes to Kernel B (``ops/temporal_attention.py``), and the rest is plain
PyTorch.  Kernels are called through their autograd Functions, so the
module trains on either path.  ``attn_impl`` is the JAX switch: its base
``xla`` (the part before ``:``, so ``:fast`` never reaches these kernels)
turns both Kernel B and Kernel C off, as ``temporal.py:125-126`` and
``:408-409`` there.  The window forward serves the sliding window and the
feature-cache streaming steps; the KV-streaming methods (``collect``,
``kv_step``) wait for the KV-streaming slice.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from video_depth_anything_torch.config import MotionModuleConfig
from video_depth_anything_torch.models.dinov2 import gelu
from video_depth_anything_torch.models.layers import GroupNorm, LayerNorm, Linear
from video_depth_anything_torch.ops.dispatch import kernels_enabled
from video_depth_anything_torch.ops.motion_module import (
    FusedMotionModuleFn,
    kernel_weights,
    motion_gate,
    sinusoidal_position_table,
)
from video_depth_anything_torch.ops.temporal_attention import (
    TemporalAttentionFn,
    temporal_attention_plain,
    temporal_gate,
)


class PositionalEncoding(nn.Module):
    def __init__(self, dim: int, max_len: int):
        super().__init__()
        self.register_buffer("pe", torch.from_numpy(sinusoidal_position_table(max_len, dim))[None])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, T, S, C)`` + the table's first T rows (in x's dtype)."""
        return x + self.pe[0, : x.shape[1], None, :].to(x.dtype)


class TemporalSelfAttention(nn.Module):
    def __init__(self, cfg: MotionModuleConfig, dim: int, attn_impl: str = "auto"):
        super().__init__()
        self.cfg = cfg
        self.use_kernels = attn_impl.partition(":")[0] != "xla"
        self.to_q = Linear(dim, dim, bias=False)
        self.to_k = Linear(dim, dim, bias=False)
        self.to_v = Linear(dim, dim, bias=False)
        self.to_out = nn.ModuleList([Linear(dim, dim), nn.Identity()])
        self.pos_encoder = PositionalEncoding(dim, cfg.temporal_max_len)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        heads = self.cfg.num_heads
        x = self.pos_encoder(x)
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        scale = (q.shape[-1] // heads) ** -0.5
        if self.use_kernels and kernels_enabled() and temporal_gate(q.shape, heads):
            out = TemporalAttentionFn.apply(q, k, v, heads, scale)
        else:
            out = temporal_attention_plain(q, k, v, heads, scale)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, 2 * inner)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(), Linear(dim * mult, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class TemporalTransformerBlock(nn.Module):
    def __init__(self, cfg: MotionModuleConfig, dim: int, attn_impl: str = "auto"):
        super().__init__()
        n = cfg.num_attention_blocks
        self.attention_blocks = nn.ModuleList(
            [TemporalSelfAttention(cfg, dim, attn_impl) for _ in range(n)])
        self.norms = nn.ModuleList([LayerNorm(dim, eps=cfg.layer_norm_eps) for _ in range(n)])
        self.ff = FeedForward(dim, cfg.ff_mult)
        self.ff_norm = LayerNorm(dim, eps=cfg.layer_norm_eps)

    def forward(self, x):
        for norm, attn in zip(self.norms, self.attention_blocks):
            x = x + attn(norm(x))
        return x + self.ff(self.ff_norm(x))


class TemporalTransformer(nn.Module):
    def __init__(self, cfg: MotionModuleConfig, channels: int, attn_impl: str = "auto"):
        super().__init__()
        inner = cfg.num_heads * (channels // cfg.num_heads)
        self.norm = GroupNorm(cfg.norm_num_groups, channels, eps=cfg.group_norm_eps)
        self.proj_in = Linear(channels, inner)
        self.transformer_blocks = nn.ModuleList(
            [TemporalTransformerBlock(cfg, inner, attn_impl)
             for _ in range(cfg.num_transformer_blocks)])
        self.proj_out = Linear(inner, channels)


class TemporalModule(nn.Module):
    """Motion module over ``(B, T, H, W, C)``; key prefix
    ``temporal_transformer`` as in the reference."""

    def __init__(self, cfg: MotionModuleConfig, channels: int, attn_impl: str = "auto"):
        super().__init__()
        self.cfg = cfg
        self.channels = channels
        self.inner = cfg.num_heads * (channels // cfg.num_heads)
        self.use_kernels = attn_impl.partition(":")[0] != "xla"
        self.temporal_transformer = TemporalTransformer(cfg, channels, attn_impl)

    def raw_params(self) -> dict:
        """Parameters in the JAX raw layout of ``fused_motion_module``."""
        tt = self.temporal_transformer
        blk = tt.transformer_blocks[0]
        attn = blk.attention_blocks
        lin = lambda m: m.weight.t()  # noqa: E731
        return dict(
            gn_scale=tt.norm.weight, gn_bias=tt.norm.bias,
            w_in=lin(tt.proj_in), b_in=tt.proj_in.bias,
            ln_scale=torch.stack([n.weight for n in blk.norms] + [blk.ff_norm.weight]),
            ln_bias=torch.stack([n.bias for n in blk.norms] + [blk.ff_norm.bias]),
            wq=torch.stack([lin(a.to_q) for a in attn]),
            wk=torch.stack([lin(a.to_k) for a in attn]),
            wv=torch.stack([lin(a.to_v) for a in attn]),
            wo=torch.stack([lin(a.to_out[0]) for a in attn]),
            bo=torch.stack([a.to_out[0].bias for a in attn]),
            w1=lin(blk.ff.net[0].proj), b1=blk.ff.net[0].proj.bias,
            w2=lin(blk.ff.net[2]), b2=blk.ff.net[2].bias,
            w_out=lin(tt.proj_out), b_out=tt.proj_out.bias,
        )

    def kernel_weights(self) -> dict:
        """Kernel C's operands from the parameters, built once and rebuilt
        only when a parameter changes (in place, or moved to another
        device or dtype): in training, once per optimizer step."""
        key = tuple((p.data_ptr(), p.device, p.dtype, p._version) for p in self.parameters())
        if getattr(self, "_kernel_weights_key", None) != key:
            with torch.no_grad():
                self._kernel_weights = kernel_weights(self.raw_params(), self.cfg)
            self._kernel_weights_key = key
        return self._kernel_weights

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = x.shape
        if self.use_kernels and kernels_enabled() and motion_gate(self.cfg, c, self.inner, t, h, w):
            p = self.raw_params()
            weights = self.kernel_weights() if x.device.type == "cuda" else None
            out = FusedMotionModuleFn.apply(x.reshape(b, t, h * w, c), self.cfg,
                                            self.cfg.num_heads, weights, tuple(p), *p.values())
            return out.reshape(x.shape)
        tt = self.temporal_transformer
        y = tt.proj_in(tt.norm(x)).reshape(b, t, h * w, self.inner)
        for blk in tt.transformer_blocks:
            y = blk(y)
        return tt.proj_out(y.reshape(b, t, h, w, self.inner)) + x
