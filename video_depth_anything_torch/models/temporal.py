"""Temporal ("motion") modules (the JAX package's ``models/temporal.py``).

GroupNorm(32) → proj_in → [2 × (LN → positions → attention over the frame
axis per location → residual), LN → GEGLU FF → residual] → proj_out →
+ input, on ``(B, T, H, W, C)`` maps.  Positions follow
``cfg.pos_embedding_type`` as JAX ``_pos``/``_qkv`` do: ``"ape"`` adds the
sinusoidal table before the projections, ``"rope"`` rotates q and k after
them (fp32, cast back); any other type raises.  Parameter names are the
reference torch keys
(``temporal_transformer.transformer_blocks.0.attention_blocks.0.to_q``, …);
a RoPE module keeps the ``pos_encoder.pe`` buffer, which the JAX export
writes for every module.

Dispatch follows the JAX package: a module that the JAX gate sends to the
fused Pallas module goes to Kernel C (``ops/motion_module.py``); otherwise
each attention whose q and k have one shape and whose shape the JAX gate
sends to the Pallas temporal core goes to Kernel B
(``ops/temporal_attention.py``), and the rest is plain PyTorch.  Kernels
are called through their autograd Functions, so the module trains on
either path.  ``attn_impl`` is the JAX switch: its base ``xla`` (the part
before ``:``, so ``:fast`` never reaches these kernels) turns both Kernel B
and Kernel C off, as ``temporal.py:125-126`` and ``:408-409`` there; its
base ``pallas`` gives Kernel B's gate ``auto=False`` (``:131-134``), which
drops the head_dim ≤ 24 rule, and leaves Kernel C's gate as it is.
``VDA_FUSED_MOTION`` is read as JAX ``temporal.py:400-422`` reads it
(``TemporalModule.fused``).

Besides the window forward (sliding window and feature-cache streaming),
the KV-streaming methods are ported (``collect``, ``kv_step``;
``temporal.py:155-260,309-333,460-492`` there).  The caches hold
position-free projections ``to_k(x)``, ``to_v(x)``, oldest → newest; the
positions of the current window are applied at attend time, as projected
sums ``to_k(x) + to_k(pe)`` where JAX forms them so.  ``collect`` never
takes Kernel C (its attentions still reach Kernel B), and a ``kv_step``,
whose q has fewer frames than k, takes the plain attention.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
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


POS_EMBEDDING_TYPES = ("ape", "rope")


def rope_tables(max_len: int, dim: int, theta: float = 10000.0):
    """cos/sin tables of the reference's RoPE variant, ``(max_len, dim/2)``
    fp32 each (JAX ``rope_tables``)."""
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64)[: dim // 2] / dim))
    angles = np.outer(np.arange(max_len, dtype=np.float64), freqs)
    return np.cos(angles).astype(np.float32), np.sin(angles).astype(np.float32)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the pairs ``(x0, x1)`` of the last axis to ``(x0·cos − x1·sin,
    x0·sin + x1·cos)`` in fp32, back in x's dtype; ``x (B, T, S, C)``,
    tables ``(T, 1, C/2)`` (``table_rows``; JAX ``_apply_rope``)."""
    xf = x.float()
    x0, x1 = xf[..., 0::2], xf[..., 1::2]
    out = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def table_rows(table: torch.Tensor, t: int, nq: Optional[int] = None) -> torch.Tensor:
    """Rows of a ``(max_len, ...)`` position table as ``(n, 1, ...)``, to
    broadcast over ``(B, n, S, ...)``: the first ``t`` (a window of t
    frames) or, with ``nq``, those of a KV step's ``nq`` query frames in a
    window of ``t``: slots 0..nq−2 and the last slot, ``min(t, max_len) −
    1``.  Sliced, not indexed: an index list would be copied to the device
    and wait for the stream at every step."""
    if nq is None:
        return table[:t, None]
    last = min(t, table.shape[0]) - 1
    return torch.cat([table[: nq - 1], table[last:last + 1]])[:, None]


class PositionalEncoding(nn.Module):
    def __init__(self, dim: int, max_len: int):
        super().__init__()
        self.register_buffer("pe", torch.from_numpy(sinusoidal_position_table(max_len, dim))[None])


class TemporalSelfAttention(nn.Module):
    def __init__(self, cfg: MotionModuleConfig, dim: int, attn_impl: str = "auto"):
        super().__init__()
        if cfg.pos_embedding_type not in POS_EMBEDDING_TYPES:
            raise ValueError(f"pos_embedding_type must be one of {POS_EMBEDDING_TYPES}, "
                             f"got {cfg.pos_embedding_type!r}")
        self.cfg = cfg
        self.rope = cfg.pos_embedding_type == "rope"
        base = attn_impl.partition(":")[0]
        self.use_kernels = base != "xla"
        self.auto = base == "auto"  # Kernel B's gate under auto; pallas forces it
        self.to_q = Linear(dim, dim, bias=False)
        self.to_k = Linear(dim, dim, bias=False)
        self.to_v = Linear(dim, dim, bias=False)
        self.to_out = nn.ModuleList([Linear(dim, dim), nn.Identity()])
        self.pos_encoder = PositionalEncoding(dim, cfg.temporal_max_len)
        if self.rope:
            cos, sin = rope_tables(cfg.temporal_max_len, dim)
            self.register_buffer("rope_cos", torch.from_numpy(cos), persistent=False)
            self.register_buffer("rope_sin", torch.from_numpy(sin), persistent=False)

    def _ape(self, dtype, t: int, nq: Optional[int] = None) -> torch.Tensor:
        """APE rows (``table_rows``) in ``dtype``."""
        return table_rows(self.pos_encoder.pe[0], t, nq).to(dtype)

    def _rotate(self, x: torch.Tensor, t: int, nq: Optional[int] = None) -> torch.Tensor:
        """RoPE at the rows ``table_rows`` picks, one per frame of x."""
        return apply_rope(x, table_rows(self.rope_cos, t, nq), table_rows(self.rope_sin, t, nq))

    def _attend(self, q, k, v) -> torch.Tensor:
        """Attention over the frame axis and the out projection; Kernel B
        only where q and k have one shape (JAX ``_attend``, ``:126-134``)."""
        heads = self.cfg.num_heads
        scale = (q.shape[-1] // heads) ** -0.5
        if (self.use_kernels and kernels_enabled() and q.shape == k.shape
                and temporal_gate(q.shape, heads, auto=self.auto)):
            out = TemporalAttentionFn.apply(q, k, v, heads, scale)
        else:
            out = temporal_attention_plain(q, k, v, heads, scale)
        return self.to_out[0](out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = x.shape[1]
        if not self.rope:
            x = x + self._ape(x.dtype, t)
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        if self.rope:
            q, k = self._rotate(q, t), self._rotate(k, t)
        return self._attend(q, k, v)

    # -- KV-cache streaming -------------------------------------------------------

    def call_collect(self, x: torch.Tensor):
        """Full-window attention that also returns the position-free
        ``to_k(x)``, ``to_v(x)`` ``(B, T, S, C)`` that seed the caches."""
        t = x.shape[1]
        k_free, v_free = self.to_k(x), self.to_v(x)
        if self.rope:
            q = self._rotate(self.to_q(x), t)
            k, v = self._rotate(k_free, t), v_free
        else:
            pe = self._ape(x.dtype, t)
            q = self.to_q(x + pe)
            k, v = k_free + self.to_k(pe), v_free + self.to_v(pe)
        return self._attend(q, k, v), k_free, v_free

    def kv_step(self, x_new: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                pin_anchor: bool = False):
        """Query frames ``x_new (B, Q, S, C)`` (the last one the newest
        frame, the only one whose K/V enter the cache) against the caches
        ``(B, T−1, S, C)``: query ``q < Q−1`` takes window slot ``q``, the
        newest frame the last slot; all attend over cache ∪ newest.
        Eviction drops the oldest entry, or with ``pin_anchor`` slot 1, so
        that slot 0 keeps the first frame.  Returns ``(out (B, Q, S, C),
        k_cache', v_cache')``."""
        nq = x_new.shape[1]
        t = k_cache.shape[1] + 1
        k_all = torch.cat([k_cache, self.to_k(x_new[:, -1:])], dim=1)
        v_all = torch.cat([v_cache, self.to_v(x_new[:, -1:])], dim=1)
        if self.rope:
            q = self._rotate(self.to_q(x_new), t, nq)
            k_att, v_att = self._rotate(k_all, t), v_all
        else:
            pe = self._ape(x_new.dtype, t)
            q = self.to_q(x_new + self._ape(x_new.dtype, t, nq))
            k_att, v_att = k_all + self.to_k(pe), v_all + self.to_v(pe)
        out = self._attend(q, k_att, v_att)
        if pin_anchor:
            return (out, torch.cat([k_all[:, :1], k_all[:, 2:]], dim=1),
                    torch.cat([v_all[:, :1], v_all[:, 2:]], dim=1))
        return out, k_all[:, 1:], v_all[:, 1:]


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

    def collect(self, x):
        """Full-window forward and ``((k, v), ...)`` per attention block."""
        caches = []
        for norm, attn in zip(self.norms, self.attention_blocks):
            out, k, v = attn.call_collect(norm(x))
            x = x + out
            caches.append((k, v))
        return x + self.ff(self.ff_norm(x)), tuple(caches)

    def kv_step(self, x_new, caches, pin_anchor: bool = False):
        """The query frames' step; LayerNorm and FF run on them alone."""
        new_caches = []
        for norm, attn, (k, v) in zip(self.norms, self.attention_blocks, caches):
            out, k, v = attn.kv_step(norm(x_new), k, v, pin_anchor)
            x_new = x_new + out
            new_caches.append((k, v))
        return x_new + self.ff(self.ff_norm(x_new)), tuple(new_caches)


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

    def kernel_weights(self, dtype: torch.dtype = torch.bfloat16) -> dict:
        """Kernel C's operands from the parameters for inputs of ``dtype``
        (the bf16 or the fp32 kernel's layout), built once per dtype and
        rebuilt only when a parameter changes (in place, or moved to
        another device or dtype): in training, once per optimizer step."""
        key = tuple((p.data_ptr(), p.device, p.dtype, p._version) for p in self.parameters())
        cache = self.__dict__.setdefault("_kernel_weights", {})
        if dtype not in cache or cache[dtype][0] != key:
            with torch.no_grad():
                cache[dtype] = (key, kernel_weights(self.raw_params(), self.cfg, dtype))
        return cache[dtype][1]

    def fused(self, t: int, h: int, w: int, c: int) -> bool:
        """Whether the module takes Kernel C, as the JAX ``_try_fused``
        decides: ``VDA_FUSED_MOTION=0`` turns it off, ``=1`` forces it past
        the gate's size rule and under an ``xla`` ``attn_impl`` (the gate's
        other terms still apply), anything else leaves the gate as it is."""
        mode = os.environ.get("VDA_FUSED_MOTION", "auto")
        if mode == "0" or not kernels_enabled() or not (self.use_kernels or mode == "1"):
            return False
        return motion_gate(self.cfg, c, self.inner, t, h, w, force=mode == "1")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = x.shape
        if self.fused(t, h, w, c):
            p = self.raw_params()
            weights = self.kernel_weights(x.dtype) if x.device.type == "cuda" else None
            out = FusedMotionModuleFn.apply(x.reshape(b, t, h * w, c), self.cfg,
                                            self.cfg.num_heads, weights, tuple(p), *p.values())
            return out.reshape(x.shape)
        tt = self.temporal_transformer
        y = tt.proj_in(tt.norm(x)).reshape(b, t, h * w, self.inner)
        for blk in tt.transformer_blocks:
            y = blk(y)
        return tt.proj_out(y.reshape(b, t, h, w, self.inner)) + x

    def collect(self, x: torch.Tensor):
        """Full-window forward without Kernel C, and the KV caches: per
        transformer block, per attention block, ``(k, v)`` each
        ``(B, T, H·W, inner)``."""
        b, t, h, w, _ = x.shape
        tt = self.temporal_transformer
        y = tt.proj_in(tt.norm(x)).reshape(b, t, h * w, self.inner)
        caches = []
        for blk in tt.transformer_blocks:
            y, c = blk.collect(y)
            caches.append(c)
        return tt.proj_out(y.reshape(b, t, h, w, self.inner)) + x, tuple(caches)

    def kv_step(self, x_new: torch.Tensor, caches, pin_anchor: bool = False):
        """Query frames ``(B, Q, H, W, C)`` against the module's caches (the
        last query the newest frame); GroupNorm, projections and FF are per
        frame, so only the query frames are computed."""
        b, q, h, w, _ = x_new.shape
        tt = self.temporal_transformer
        y = tt.proj_in(tt.norm(x_new)).reshape(b, q, h * w, self.inner)
        new_caches = []
        for blk, c in zip(tt.transformer_blocks, caches):
            y, c = blk.kv_step(y, c, pin_anchor)
            new_caches.append(c)
        return tt.proj_out(y.reshape(b, q, h, w, self.inner)) + x_new, tuple(new_caches)
