"""Model and inference configuration of the PyTorch port.

The same frozen dataclasses as ``video_depth_anything_tpu/config.py``,
kept as a copy so that this package never imports the JAX one.  Only the
fields that the port reads are carried.  ``fp32_head_island``,
``packed_output_stack`` and ``fused_output_tail`` are the JAX fields of the
same names; the last two decide, as in JAX, which heads the output tail
kernel takes (``ops/output_tail.output_tail_gate``): the port's plain
output stack is always the unpacked chain, which JAX holds exact against
its packed one, so ``packed_output_stack`` changes no result.
``remat_motion`` recomputes the four motion modules in the backward
(``torch.utils.checkpoint``), as JAX's ``nn.remat`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

# Sliding-window inference contract (reference video_depth.py:29-33).
INFER_LEN = 32
OVERLAP = 10
KEYFRAMES: Tuple[int, ...] = (0, 12, 24, 25, 26, 27, 28, 29, 30, 31)
INTERP_LEN = 8


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """DINOv2 encoder hyper-parameters."""

    embed_dim: int
    depth: int
    num_heads: int
    mlp_ratio: float = 4.0
    patch_size: int = 14
    img_size: int = 518
    init_values: float = 1.0
    interpolate_offset: float = 0.1
    ffn_layer: str = "mlp"  # "mlp" | "swiglufused"
    norm_eps: float = 1e-6

    @property
    def pos_grid(self) -> int:
        return self.img_size // self.patch_size


@dataclasses.dataclass(frozen=True)
class MotionModuleConfig:
    """Temporal ("motion") module hyper-parameters."""

    num_heads: int = 8
    num_transformer_blocks: int = 1
    num_attention_blocks: int = 2
    temporal_max_len: int = 32
    norm_num_groups: int = 32
    pos_embedding_type: str = "ape"
    group_norm_eps: float = 1e-6
    layer_norm_eps: float = 1e-5
    ff_mult: int = 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    encoder: str
    vit: ViTConfig
    features: int
    out_channels: Tuple[int, int, int, int]
    intermediate_layer_idx: Tuple[int, int, int, int]
    motion: MotionModuleConfig = MotionModuleConfig()
    num_frames: int = 32
    # Recompute the motion modules in the backward instead of keeping their
    # activations (fp32 norm statistics, the 8x-wide GEGLU input, attention
    # probabilities); one more forward through them per training step.
    remat_motion: bool = False
    # The reference forces output_conv2 to fp32 to dodge *fp16* range and
    # precision collapse (dpt_temporal.py:95-97 there).  bf16 has fp32's
    # exponent range and the products accumulate in fp32 regardless, so in
    # bf16 the island buys little accuracy while it moves the (T, 518, 518,
    # 32) maps of output_conv2 in fp32.  In fp32 model mode everything is
    # fp32 anyway; set True to force the cast in bf16 (``run.py
    # --fp32_island``).  The output tail kernel refuses while it is on.
    fp32_head_island: bool = False
    # JAX runs vits' and vitb's output stack in a 2x2 space-to-depth layout
    # and leaves only unpacked heads to its fused tail; off, those heads'
    # tails (C = 32, 64) reach the tail's gate too.  The port computes the
    # unpacked chain either way.
    packed_output_stack: bool = True
    # Off: the output tail kernel never runs (the plain chain does).
    fused_output_tail: bool = True


_VIT_CONFIGS: Mapping[str, ViTConfig] = {
    "vits": ViTConfig(embed_dim=384, depth=12, num_heads=6),
    "vitb": ViTConfig(embed_dim=768, depth=12, num_heads=12),
    "vitl": ViTConfig(embed_dim=1024, depth=24, num_heads=16),
    "vitg": ViTConfig(embed_dim=1536, depth=40, num_heads=24, ffn_layer="swiglufused"),
}

_MODEL_CONFIGS = {
    "vits": dict(features=64, out_channels=(48, 96, 192, 384),
                 intermediate_layer_idx=(2, 5, 8, 11)),
    "vitb": dict(features=128, out_channels=(96, 192, 384, 768),
                 intermediate_layer_idx=(2, 5, 8, 11)),
    "vitl": dict(features=256, out_channels=(256, 512, 1024, 1024),
                 intermediate_layer_idx=(4, 11, 17, 23)),
    "vitg": dict(features=384, out_channels=(1536, 1536, 1536, 1536),
                 intermediate_layer_idx=(9, 19, 29, 39)),
}


def get_model_config(encoder: str, num_frames: int = 32) -> ModelConfig:
    if encoder not in _MODEL_CONFIGS:
        raise ValueError(
            f"unknown encoder {encoder!r}; expected one of {sorted(_MODEL_CONFIGS)}"
        )
    cfg = _MODEL_CONFIGS[encoder]
    return ModelConfig(
        encoder=encoder,
        vit=_VIT_CONFIGS[encoder],
        features=cfg["features"],
        out_channels=tuple(cfg["out_channels"]),
        intermediate_layer_idx=tuple(cfg["intermediate_layer_idx"]),
        num_frames=num_frames,
        motion=MotionModuleConfig(temporal_max_len=num_frames),
    )
