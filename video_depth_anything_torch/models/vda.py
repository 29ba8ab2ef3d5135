"""Top-level VideoDepthAnything model and the ``VDAModel`` bundle.

``VideoDepthAnything.forward(x)`` with ``x: (B, T, H, W, 3)`` normalized
frames (H, W multiples of 14) → ``(B, T, H, W)`` non-negative inverse
depth, as ``video_depth_anything_tpu/models/vda.py`` ``__call__``.  The
state dict uses the reference torch keys (``pretrained.*``, ``head.*``), so
a released ``.pth`` loads with ``load_state_dict(strict=True)``.  Besides
the window forward it has the feature-cache streaming methods of the JAX
module (``encode_level_features``, ``streaming_step``,
``streaming_head_step``, ``streaming_chunk_step``; ``vda.py:67-149``
there), which ``inference/streaming.py`` drives, and the KV-streaming ones
(``streaming_kv_start``, ``streaming_kv_step``, ``streaming_kv_head_step``;
``vda.py:153-215`` there), which ``inference/kv_streaming.py`` drives.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from video_depth_anything_torch.config import ModelConfig, get_model_config
from video_depth_anything_torch.models.dinov2 import DinoViT
from video_depth_anything_torch.models.dpt import DPTHeadTemporal
from video_depth_anything_torch.ops.attention import parse_attn_impl
from video_depth_anything_torch.ops.resize import bilinear_resize
from video_depth_anything_torch.utils.device import resolve_device


class VideoDepthAnything(nn.Module):
    def __init__(self, cfg: ModelConfig, attn_impl: str = "auto"):
        super().__init__()
        self.cfg = cfg
        self.pretrained = DinoViT(cfg.vit, attn_impl)
        self.head = DPTHeadTemporal(cfg, attn_impl)

    def _check_hw(self, h: int, w: int):
        p = self.cfg.vit.patch_size
        if h % p or w % p:
            raise ValueError(f"frame size ({h}, {w}) must be a multiple of the patch size {p}")
        return h // p, w // p

    def forward(self, x: torch.Tensor, skip_tmp_block: bool = False,
                freeze_encoder: bool = False) -> torch.Tensor:
        """``freeze_encoder`` runs the encoder under ``torch.no_grad()``: no
        encoder backward (the JAX trainer's frozen-encoder step)."""
        b, t, h, w, _ = x.shape
        ph, pw = self._check_hw(h, w)
        with torch.no_grad() if freeze_encoder else contextlib.nullcontext():
            feats = self.pretrained(x.reshape(b * t, h, w, 3), self.cfg.intermediate_layer_idx)
        depth = self.head(feats, b, ph, pw, skip_tmp_block).to(x.dtype)
        return bilinear_resize(depth, h, w).reshape(b, t, h, w)

    # -- feature-cache streaming ----------------------------------------------

    def encode_level_features(self, x: torch.Tensor):
        """``(N, H, W, 3)`` frames → their 4 pre-motion level features, the
        entries of the streaming cache."""
        _, h, w, _ = x.shape
        ph, pw = self._check_hw(h, w)
        return self.head.level_features(self.pretrained(x, self.cfg.intermediate_layer_idx), ph, pw)

    def streaming_step(self, x: torch.Tensor, cached, pred_idx=None, skip_tmp_block: bool = False):
        """One frame ``(1, H, W, 3)`` and the gathered cache windows →
        (depth ``(P, H, W)`` in the compute dtype, the frame's level
        features)."""
        _, h, w, _ = x.shape
        ph, pw = self._check_hw(h, w)
        feats = self.pretrained(x, self.cfg.intermediate_layer_idx)
        depth, new = self.head.streaming_forward(feats, cached, ph, pw, pred_idx, skip_tmp_block)
        return bilinear_resize(depth.to(x.dtype), h, w)[..., 0], new

    def streaming_head_step(self, levels, cached, pred_idx=None, skip_tmp_block: bool = False):
        """The post-encoder half of ``streaming_step``, from the frame's
        level features (each ``(1, h_l, w_l, C_l)``): the aligned chunk
        batches the encoder over K frames and runs this K times."""
        l1 = levels[0]
        ph, pw = l1.shape[1] // 4, l1.shape[2] // 4
        depth, new = self.head.streaming_head_step(levels, cached, ph, pw, pred_idx, skip_tmp_block)
        return bilinear_resize(depth.to(l1.dtype), ph * 14, pw * 14)[..., 0], new

    def streaming_chunk_step(self, x: torch.Tensor, cache, gather_idx: torch.Tensor,
                             skip_tmp_block: bool = False):
        """K steady frames ``(K, H, W, 3)`` in one batch.  ``gather_idx
        (K, T-1)`` indexes ``cat(cache, new features)``: positions at or
        past ``cache_len`` are frames of this chunk.  Returns (depth
        ``(K, H, W)``, the K frames' level features); the caller writes
        them into their freed cache slots."""
        _, h, w, _ = x.shape
        ph, pw = self._check_hw(h, w)
        n1, n2, n3, n4 = self.encode_level_features(x)
        c3, c4 = cache[2], cache[3]
        w3 = torch.cat([torch.cat([c3, n3])[gather_idx], n3[:, None]], dim=1)
        w4 = torch.cat([torch.cat([c4, n4])[gather_idx], n4[:, None]], dim=1)
        depth = self.head.streaming_chunk_forward(n1, n2, w3, w4, ph, pw, skip_tmp_block)
        return bilinear_resize(depth.to(x.dtype), h, w)[..., 0], (n1, n2, n3, n4)

    # -- KV-cache streaming -------------------------------------------------------

    def streaming_kv_start(self, x: torch.Tensor, skip_tmp_block: bool = False):
        """Warm-up: one window ``(1, T, H, W, 3)`` → (depth ``(1, T, H,
        W)``, the motion modules' KV caches over all T frames)."""
        b, t, h, w, _ = x.shape
        ph, pw = self._check_hw(h, w)
        feats = self.pretrained(x.reshape(b * t, h, w, 3), self.cfg.intermediate_layer_idx)
        depth, caches = self.head.window_forward_collect_kv(feats, b, ph, pw, skip_tmp_block)
        return bilinear_resize(depth.to(x.dtype), h, w).reshape(b, t, h, w), caches

    def streaming_kv_step(self, x: torch.Tensor, kv_caches, skip_tmp_block: bool = False,
                          anchor_levels=None):
        """The newest frame ``(1, H, W, 3)`` and the caches → (depth ``(Q,
        H, W)``, the shifted caches); with ``anchor_levels`` row 0 is the
        anchor's new prediction and row 1 the newest frame's."""
        _, h, w, _ = x.shape
        ph, pw = self._check_hw(h, w)
        feats = self.pretrained(x, self.cfg.intermediate_layer_idx)
        depth, caches = self.head.streaming_kv_forward(feats, kv_caches, ph, pw, skip_tmp_block,
                                                       anchor_levels)
        return bilinear_resize(depth.to(x.dtype), h, w)[..., 0], caches

    def streaming_kv_head_step(self, levels, kv_caches, skip_tmp_block: bool = False,
                               anchor_levels=None):
        """The post-encoder half of ``streaming_kv_step``, from the frame's
        level features (each ``(1, h_l, w_l, C_l)``): the chunked KV steps
        batch the encoder over K frames and run this K times."""
        l1 = levels[0]
        ph, pw = l1.shape[1] // 4, l1.shape[2] // 4
        depth, caches = self.head.streaming_kv_head_step(levels, kv_caches, ph, pw,
                                                         skip_tmp_block, anchor_levels)
        return bilinear_resize(depth.to(l1.dtype), ph * 14, pw * 14)[..., 0], caches


def init_parameters(module: nn.Module, seed: int = 0) -> None:
    """Seeded random init in the JAX package's spirit: LeCun-normal
    weights, zero biases, unit norm scales and LayerScale, N(0, 0.02)
    positional embedding, zero cls/mask tokens and zero ``proj_out`` (a
    fresh motion module is the identity)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name.endswith("pos_embed"):
                val = torch.randn(p.shape, generator=gen) * 0.02
            elif leaf == "weight" and p.dim() >= 2 and ".proj_out." not in name:
                val = torch.randn(p.shape, generator=gen) / np.sqrt(p[0].numel())
            elif (leaf == "weight" and p.dim() == 1) or leaf == "gamma":
                val = torch.ones(p.shape)
            else:
                val = torch.zeros(p.shape)
            p.copy_(val)


class VDAModel:
    """Config + module + device/dtype; ``infer_window(frames)`` takes
    normalized ``(B, T, H, W, 3)`` frames and returns ``(B, T, H, W)``
    inverse depth on the device.  Runs on the card unless
    ``device="cpu"``; ``dtype`` bf16 (the default) or fp32 (every kernel
    then takes its fp32 counterpart; the output tail's gate says no, as in
    JAX).  ``attn_impl``: ``auto|pallas|xla`` with an optional
    ``:fast`` (``ops/attention.parse_attn_impl``)."""

    def __init__(self, encoder: str = "vits", device=None, dtype=torch.bfloat16,
                 cfg: Optional[ModelConfig] = None, attn_impl: str = "auto"):
        self.cfg = cfg or get_model_config(encoder)
        self.device = resolve_device(device)
        parse_attn_impl(attn_impl, self.device.type)
        self.dtype = dtype
        self.attn_impl = attn_impl
        # built on its device: PyTorch's default init, which init_params or
        # a checkpoint overwrites, runs there (on the host it takes seconds)
        with torch.device(self.device):
            module = VideoDepthAnything(self.cfg, attn_impl)
        self.module = module.to(self.device).eval()

    def init_params(self, seed: int = 0) -> None:
        init_parameters(self.module, seed)

    def load_state_dict(self, state, strict: bool = True):
        state = {k: torch.as_tensor(np.asarray(v, np.float32)) if isinstance(v, np.ndarray) else v
                 for k, v in state.items()}
        return self.module.load_state_dict(state, strict=strict)

    @torch.inference_mode()
    def infer_window(self, frames, skip_tmp_block: bool = False) -> torch.Tensor:
        x = torch.as_tensor(frames).to(self.device, self.dtype)
        return self.module(x, skip_tmp_block=skip_tmp_block)
