"""DINOv2 ViT encoder (the JAX package's ``models/dinov2.py``).

Patch embed as one GEMM over flattened 14×14 patches, cls token, the
bicubic-interpolated positional embedding (scale factors ``(ph + 0.1) /
37``), pre-norm blocks with LayerScale, and the tapped blocks' tokens after
the final LayerNorm with the cls token dropped.  Parameter names are the
reference torch keys (``patch_embed.proj``, ``blocks.{i}.attn.qkv``, …).
``attn_impl`` (``auto|pallas|xla`` with an optional ``:fast``) goes to
every block's attention, as in the JAX ``Attention``/``Block``/``DinoViT``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from video_depth_anything_torch.config import ViTConfig
from video_depth_anything_torch.models.layers import LayerNorm, Linear
from video_depth_anything_torch.ops.attention import multi_head_attention
from video_depth_anything_torch.ops.resize import bicubic_pos_embed_resize


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh GELU in bf16, exact erf GELU otherwise (JAX ``_gelu``)."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, attn_impl: str = "auto"):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.attn_impl = attn_impl
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Split and reshape by this rank's width, ``num_heads · head_dim``:
        under tensor parallelism (``parallel/mesh.shard_module``) the qkv
        projection holds this rank's heads of each of q, k and v."""
        b, n, _ = x.shape
        width = self.num_heads * self.head_dim
        q, k, v = self.qkv(x).split(width, dim=-1)
        shape = (b, n, self.num_heads, self.head_dim)
        out = multi_head_attention(q.view(shape), k.view(shape), v.view(shape), self.attn_impl)
        return self.proj(out.reshape(b, n, width))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class SwiGLU(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        hidden = (int(hidden * 2 / 3) + 7) // 8 * 8
        self.w12 = Linear(dim, 2 * hidden)
        self.w3 = Linear(hidden, dim)

    def forward(self, x):
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(x1) * x2)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig, attn_impl: str = "auto"):
        super().__init__()
        d = cfg.embed_dim
        self.norm1 = LayerNorm(d, eps=cfg.norm_eps)
        self.attn = Attention(d, cfg.num_heads, attn_impl)
        self.ls1 = LayerScale(d, cfg.init_values)
        self.norm2 = LayerNorm(d, eps=cfg.norm_eps)
        ffn = SwiGLU if cfg.ffn_layer == "swiglufused" else Mlp
        self.mlp = ffn(d, int(d * cfg.mlp_ratio))
        self.ls2 = LayerScale(d, cfg.init_values)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.patch = patch
        self.proj = nn.Conv2d(3, dim, patch, patch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(N, H, W, 3)`` → ``(N, ph·pw, D)`` via one GEMM over patches."""
        n, h, w, _ = x.shape
        p = self.patch
        ph, pw = h // p, w // p
        patches = x.reshape(n, ph, p, pw, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(n, ph * pw, p * p * 3)
        weight = self.proj.weight.permute(0, 2, 3, 1).reshape(self.proj.out_channels, -1)
        return F.linear(patches, weight.to(x.dtype), self.proj.bias.to(x.dtype))


class DinoViT(nn.Module):
    """``forward(x, layer_idx)`` with ``x: (N, H, W, 3)`` → tuple of
    ``(N, ph·pw, D)`` post-norm patch tokens of the tapped blocks."""

    def __init__(self, cfg: ViTConfig, attn_impl: str = "auto"):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg.patch_size, d)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.pos_grid**2 + 1, d))
        self.mask_token = nn.Parameter(torch.zeros(1, d))  # unused at inference
        self.blocks = nn.ModuleList([Block(cfg, attn_impl) for _ in range(cfg.depth)])
        self.norm = LayerNorm(d, eps=cfg.norm_eps)

    def interpolate_pos_encoding(self, ph: int, pw: int) -> torch.Tensor:
        cfg = self.cfg
        grid = cfg.pos_grid
        if ph == grid and pw == grid:
            return self.pos_embed
        pe = self.pos_embed.float()
        cls_pos, patch_pos = pe[:, :1], pe[0, 1:].reshape(grid, grid, cfg.embed_dim)
        patch_pos = bicubic_pos_embed_resize(
            patch_pos, ph, pw, (ph + cfg.interpolate_offset) / grid,
            (pw + cfg.interpolate_offset) / grid,
        ).reshape(1, ph * pw, cfg.embed_dim)
        return torch.cat([cls_pos, patch_pos], dim=1)

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """``(N, H, W, 3)`` → ``(N, ph·pw + 1, D)`` tokens: patches, the cls
        token and the positional embedding (the first pipeline stage's
        work, ``parallel/pipeline_parallel.py``)."""
        n, h, w, _ = x.shape
        p = self.cfg.patch_size
        ph, pw = h // p, w // p
        dtype = x.dtype
        tokens = self.patch_embed(x)
        cls = self.cls_token.to(dtype).expand(n, 1, -1)
        tokens = torch.cat([cls, tokens], dim=1)
        return tokens + self.interpolate_pos_encoding(ph, pw).to(dtype)

    def forward(self, x: torch.Tensor, layer_idx: Sequence[int]) -> Tuple[torch.Tensor, ...]:
        tokens = self.embed(x)
        want = set(int(i) for i in layer_idx)
        taps = {}
        for i, blk in enumerate(self.blocks):
            tokens = blk(tokens)
            if i in want:
                taps[i] = tokens
        return tuple(self.norm(taps[int(i)])[:, 1:] for i in layer_idx)
