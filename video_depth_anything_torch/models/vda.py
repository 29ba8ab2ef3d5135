"""Top-level VideoDepthAnything model and the ``VDAModel`` bundle.

``VideoDepthAnything.forward(x)`` with ``x: (B, T, H, W, 3)`` normalized
frames (H, W multiples of 14) → ``(B, T, H, W)`` non-negative inverse
depth, as ``video_depth_anything_tpu/models/vda.py`` ``__call__``.  The
state dict uses the reference torch keys (``pretrained.*``, ``head.*``), so
a released ``.pth`` loads with ``load_state_dict(strict=True)``.
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
from video_depth_anything_torch.ops.resize import bilinear_resize
from video_depth_anything_torch.utils.device import resolve_device


class VideoDepthAnything(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.pretrained = DinoViT(cfg.vit)
        self.head = DPTHeadTemporal(cfg)

    def forward(self, x: torch.Tensor, skip_tmp_block: bool = False,
                freeze_encoder: bool = False) -> torch.Tensor:
        """``freeze_encoder`` runs the encoder under ``torch.no_grad()``: no
        encoder backward (the JAX trainer's frozen-encoder step)."""
        b, t, h, w, _ = x.shape
        p = self.cfg.vit.patch_size
        if h % p or w % p:
            raise ValueError(f"frame size ({h}, {w}) must be a multiple of the patch size {p}")
        with torch.no_grad() if freeze_encoder else contextlib.nullcontext():
            feats = self.pretrained(x.reshape(b * t, h, w, 3), self.cfg.intermediate_layer_idx)
        depth = self.head(feats, b, h // p, w // p, skip_tmp_block).to(x.dtype)
        return bilinear_resize(depth, h, w).reshape(b, t, h, w)


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
    ``device="cpu"``."""

    def __init__(self, encoder: str = "vits", device=None, dtype=torch.bfloat16,
                 cfg: Optional[ModelConfig] = None):
        self.cfg = cfg or get_model_config(encoder)
        self.device = resolve_device(device)
        if self.device.type == "cuda" and dtype != torch.bfloat16:
            raise NotImplementedError("fp32 inference on the card is not yet ported")
        if self.device.type == "cuda" and self.cfg.encoder not in ("vits", "vitl"):
            # vitb reaches Kernel C at C = 128 and 384 and Kernel B at d = 16,
            # which come with its own slice; the CPU runs it plain.
            raise NotImplementedError(
                f"encoder {self.cfg.encoder!r} on the card is not yet ported (vits and vitl "
                "only; vitb needs Kernel C at C = 128 and 384 and Kernel B at d = 16)")
        self.dtype = dtype
        self.module = VideoDepthAnything(self.cfg).to(self.device).eval()

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
