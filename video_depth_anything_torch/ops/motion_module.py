"""Kernel C: the fused whole motion module (``csrc/motion_module.cu``, and on
fp32 operands ``csrc/motion_module_f32.cu``).

Replaces ``video_depth_anything_tpu/ops/pallas_motion.py`` ``_motion_kernel``
(``fused_motion_module``).  ``motion_module_plain`` is the port of
``motion_module_reference`` (``pallas_motion.py:290``), the same math as
``models.temporal.TemporalModule``; ``gn_fold`` folds the GroupNorm
statistics into a per-(b, t, c) scale and shift in plain PyTorch, outside
the kernel, as ``_gn_fold`` does outside ``pallas_call``.

``motion_gate`` is the JAX dispatch rule (``models/temporal.py:396-423``
and ``try_fused_motion_module``): one transformer block with APE, inner ==
channels, h·w ≥ 2048, head_dim ≤ 64, and the TPU kernel's packing and VMEM
plan admit the shape.

Raw parameters use the JAX layout: ``w_*`` are ``(in, out)`` so that
``y = x @ w``; ``wq/wk/wv/wo`` and ``bo`` are stacked over the attention
blocks, ``ln_scale/ln_bias`` over [attention blocks..., ff].

``FusedMotionModuleFn`` is the differentiable entry: Kernel C forward (the
plain version on CPU tensors), and a backward that recomputes through
``motion_module_plain`` as the JAX VJP recomputes through
``motion_module_reference`` (``pallas_motion.py:401-407``), with gradients
for x and every raw parameter.  ``fused_motion_module`` and
``motion_module_launch`` are raw and keep no autograd history.

fp32 inputs take the fp32 kernel (the JAX kernel on fp32 inputs: its gate
and plan look at shapes alone, its body computes in x's dtype with the erf
GELU), its products in 3xTF32 on the tensor cores, on its own weight layout
(``weight_blocks_f32``: hi and lo tiles split once on the host,
``kernel_weights(p, cfg, torch.float32)``); ``fused_motion_module.launches``
counts the bf16 kernel's launches, ``f32_launches`` the fp32 kernel's.

The resident kernels take 8 heads, two attention blocks and ff_mult 4 at
C in ``RESIDENT_C`` (``resident``).  Every other module the gate admits
(``kernel_takes``: any C, heads, attention blocks and ff_mult; at the
shipped encoders' widths, C = 768 and 1024: vitb m1, vitl m0/m1 under
``VDA_FUSED_MOTION=1``) takes ``csrc/motion_module_wide.cu``
instead, in either dtype: a chain of hand-written launches (row norms,
``wgmma`` products with fused epilogues, the frame attention) with the
activations in a scratch that the wrapper allocates, on its own weight
layout (``weight_blocks_wide``, bf16 tiles of 128 × 256 or 128 × 128 or
fp32 hi/lo tiles of 128 × 128, zero-padded to whole tiles; the hidden units
to whole halves of the GEGLU tile, ``wide_hidden``); its products are
persistent CTAs walking output tiles in ``wide_tile``'s grouped order; it
counts on ``fused_motion_module.wide_launches`` and ``wide_f32_launches``.

Bound on the H100: tensor-core FLOPs (~44·C² per token at two blocks and
ff_mult 4, ``(2 + 4·n_attn)·C² + 6·ff_mult·C²`` in general); the fp32
kernel's, three times the FLOPs at the tensor cores' TF32 rate; see the
sources.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from video_depth_anything_torch.config import MotionModuleConfig
from video_depth_anything_torch.ops import cuda_build
from video_depth_anything_torch.ops.dispatch import recompute_vjp

_LANES = 128
_VMEM_BUDGET = 96 * 1024 * 1024


def sinusoidal_position_table(max_len: int, dim: int) -> np.ndarray:
    """Sinusoidal APE table ``(max_len, dim)`` fp32: even columns sin, odd
    columns cos, frequency ``exp(-log(10000)·2i/dim)``."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, dim, 2, dtype=np.float64) * (-np.log(10000.0) / dim))
    pe = np.zeros((max_len, dim), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe.astype(np.float32)


def _gunit(c: int) -> int:
    return math.lcm(c, _LANES) // c


def _auto_pack(c: int, heads: int) -> int:
    g = _gunit(c)
    p = max(1, min(_LANES // heads, 1024 // c))
    p -= p % g
    while p > g and (p * c) % _LANES != 0:
        p -= g
    return max(p, 0)


def _tpu_plan_fits(t: int, pack: int, c: int, ff_mult: int, d: int, n_attn: int) -> bool:
    """Whether the TPU kernel's VMEM plan (``_plan_s_blk``) finds a block."""
    gunit = _gunit(c)
    c_grp = 256 if d == 128 else pack * c
    weight_bytes = (
        (2 + 4 * n_attn) * c * c * 2 * gunit * gunit
        + 3 * ff_mult * c * c * 2 * gunit * gunit
        + 2 * c_grp * _LANES * 2
        + 2 * pack * c * _LANES * 4
    )
    cp = pack * c
    for s_blk in (256, 192, 128, 96, 64, 48, 32, 16, 8):
        rows = t * s_blk
        ff_chunk = rows
        while ff_chunk > 256 and ff_chunk % 2 == 0:
            ff_chunk //= 2
        est = (
            2 * (t * s_blk * cp * 2) * 2
            + 6 * rows * cp * 2
            + ff_chunk * (3 * ff_mult * c * pack) * 2
            + rows * _LANES * 4 * 2
            + rows * c_grp * (2 + 2 + 4)
            + weight_bytes
        )
        if est <= _VMEM_BUDGET:
            return True
    return False


def motion_gate(cfg: MotionModuleConfig, channels: int, inner: int, t: int, h: int, w: int,
                force: bool = False) -> bool:
    """True where the JAX package runs the fused Pallas motion module;
    ``force`` (``VDA_FUSED_MOTION=1``) drops its h·w ≥ 2048 and d ≤ 64
    rule, as JAX ``models/temporal.py:410-418`` does, and keeps the rest."""
    heads = cfg.num_heads
    if channels != inner or cfg.num_transformer_blocks != 1:
        return False
    if cfg.pos_embedding_type != "ape":
        return False
    c = channels
    if c % heads or t < 8:
        return False
    d = c // heads
    if not force and not (h * w >= 2048 and d <= 64):
        return False
    pack, gunit = _auto_pack(c, heads), _gunit(c)
    if pack < gunit or (pack * c) % _LANES or pack % gunit:
        return False
    return _tpu_plan_fits(t, pack, c, cfg.ff_mult, d, cfg.num_attention_blocks)


def gn_fold(x: torch.Tensor, p: Dict, cfg: MotionModuleConfig):
    """GroupNorm statistics of ``(B, T, S, C)`` per (b, t, group), folded
    with the affine parameters into fp32 ``(B, T, C)`` scale and shift."""
    b, t, s, c = x.shape
    g = cfg.norm_num_groups
    xf = x.float().reshape(b, t, s, g, c // g)
    var, mean = torch.var_mean(xf, dim=(2, 4), unbiased=False)
    inv = torch.rsqrt(var + cfg.group_norm_eps)
    a = inv.repeat_interleave(c // g, dim=-1) * p["gn_scale"].float()
    shift = p["gn_bias"].float() - mean.repeat_interleave(c // g, dim=-1) * a
    return a.contiguous(), shift.contiguous()


def _ln(h, sc, bi, eps):
    hf = h.float()
    mean = hf.mean(dim=-1, keepdim=True)
    var = torch.clamp((hf * hf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    return ((hf - mean) * (torch.rsqrt(var + eps) * sc.float()) + bi.float()).to(h.dtype)


def _gelu(x):
    # tanh form in bf16, exact erf in fp32 (models/dinov2.py:_gelu in JAX)
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16 else "none")


def motion_module_plain(x: torch.Tensor, p: Dict, cfg: MotionModuleConfig, heads: int,
                        product=None):
    """The whole motion module on ``(B, T, S, C)`` from raw parameters;
    ``product(a, w)`` computes its weight products where given (``a @ w``
    where not: ``chip_smoke.motion_split_plain`` passes wrong 3xTF32
    splits)."""
    from video_depth_anything_torch.ops.temporal_attention import temporal_attention_plain

    mm = product or torch.matmul
    b, t, s, c = x.shape
    dt = x.dtype
    g = cfg.norm_num_groups
    xf = x.float().reshape(b, t, s, g, c // g)
    var, mean = torch.var_mean(xf, dim=(2, 4), keepdim=True, unbiased=False)
    xf = ((xf - mean) * torch.rsqrt(var + cfg.group_norm_eps)).reshape(b, t, s, c)
    y = (xf * p["gn_scale"].float() + p["gn_bias"].float()).to(dt)
    y = mm(y, p["w_in"].to(dt)) + p["b_in"].to(dt)
    d = c // heads
    pe = torch.from_numpy(sinusoidal_position_table(cfg.temporal_max_len, c)[:t]).to(x.device, dt)
    for i in range(cfg.num_attention_blocks):
        h = _ln(y, p["ln_scale"][i], p["ln_bias"][i], cfg.layer_norm_eps)
        hp = h + pe[None, :, None, :]
        q = mm(hp, p["wq"][i].to(dt))
        k = mm(hp, p["wk"][i].to(dt))
        v = mm(hp, p["wv"][i].to(dt))
        out = temporal_attention_plain(q, k, v, heads, d**-0.5)
        y = y + mm(out, p["wo"][i].to(dt)) + p["bo"][i].to(dt)
    h = _ln(y, p["ln_scale"][-1], p["ln_bias"][-1], cfg.layer_norm_eps)
    hh = mm(h, p["w1"].to(dt)) + p["b1"].to(dt)
    hh, gate = hh.chunk(2, dim=-1)
    hh = hh * _gelu(gate)
    y = y + mm(hh, p["w2"].to(dt)) + p["b2"].to(dt)
    y = mm(y, p["w_out"].to(dt)) + p["b_out"].to(dt)
    return y + x


def sw128_tiles(w_in_out: torch.Tensor, rows: int = 64) -> torch.Tensor:
    """``(K, N)`` JAX-layout weight → bf16 ``(K/64 · N/rows, rows, 64)``: the
    wgmma B tiles of ``y = x @ w``, k panel major and n block inner, each
    ``rows`` output columns × 64 inputs (K-major, 128 bytes per row) in the
    128-byte swizzle that a TMA box with ``CU_TENSOR_MAP_SWIZZLE_128B``
    lands in shared memory: row n's 16-byte chunk j sits at chunk
    ``j ^ (n % 8)``.  A bulk copy of a tile is then a wgmma operand as it
    is (``csrc/motion_module.cuh``, ``csrc/output_tail.cu``)."""
    k, n = w_in_out.shape
    w = w_in_out.t().to(torch.bfloat16).reshape(n // rows, rows, k // 64, 8, 8)
    w = w.permute(2, 0, 1, 3, 4)  # (kp, nb, row, chunk, 8)
    j = torch.arange(8)
    src = j[None, :] ^ (torch.arange(rows) % 8)[:, None]  # chunk stored at j holds src[row, j]
    w = w[:, :, torch.arange(rows)[:, None], src.to(w.device)]
    return w.reshape(-1, rows, 64).contiguous()


def nsplit(c: int) -> int:
    """Kernel C's warpgroups per 64-row block (``csrc/motion_module.cuh``
    Plan), which take its 64-wide output blocks round robin: three at C =
    192 and 384, two at 256, one at 64 and 128."""
    return {192: 3, 256: 2, 384: 3}.get(c, 1)


def weight_blocks(p: Dict) -> torch.Tensor:
    """Kernel C's weights as the one bf16 sequence of 64 × 64 tiles
    (``sw128_tiles``) that its producer warp streams, in the order the CTA
    consumes them: proj_in; per attention block q, k, v, out; per
    feed-forward step f the h columns of hidden chunks ``f·ns + cs`` (cs <
    ns = ``nsplit(C)``), then their gate columns, then the rows of w2 for
    those chunks; proj_out."""
    c = p["w_in"].shape[0]
    ns = nsplit(c)
    w1 = p["w1"]
    gemms = [p["w_in"]]
    for i in range(p["wq"].shape[0]):
        gemms += [p["wq"][i], p["wk"][i], p["wv"][i], p["wo"][i]]
    for f in range(4 * c // (64 * ns)):
        j0 = f * ns * 64
        gemms += [w1[:, j0:j0 + ns * 64], w1[:, 4 * c + j0:4 * c + j0 + ns * 64],
                  p["w2"][j0:j0 + ns * 64]]
    gemms.append(p["w_out"])
    return torch.cat([sw128_tiles(g).reshape(-1) for g in gemms])


# The fp32 kernel's plan (csrc/motion_module_f32.cu Plan): consumer
# warpgroups, which take the 64-wide output blocks n = cs, cs + nsplit, ...
# of each product, and the ring stages of each warpgroup.  Rows a CTA: 64.
F32_PLAN = {64: (1, 2), 128: (2, 4), 192: (3, 2), 256: (2, 3), 384: (2, 2)}
F32_ROWS = 64
# Input order within each 32-input panel of an fp32 tile: logical position L
# (k8 step L // 8, slot L % 8 of the tf32 A fragment) holds input
# 16 (L // 16) + 4 (L % 4) + 2 ((L // 8) % 2) + (L % 8) // 4, so that one
# 16-byte load of an activation row gives a thread its A fragments of two
# k8 steps.
F32_PANEL_ORDER = tuple(16 * (L // 16) + 4 * (L % 4) + 2 * ((L // 8) % 2) + (L % 8) // 4
                        for L in range(32))


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (10 mantissa bits, to nearest, ties away
    from zero), as ``cvt.rna.tf32.f32`` rounds it."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32).view(x.shape)


def f32_tiles(w_in_out: torch.Tensor) -> torch.Tensor:
    """``(K, N)`` JAX-layout fp32 weight → ``(N/64, K/32, 2, 64, 32)``: for
    output block n and input panel k, the 3xTF32 split (hi = rna(w), lo =
    rna(w − hi)) as two K-major tiles of 64 output columns × 32 inputs in
    ``F32_PANEL_ORDER``, each row's 16-byte chunk j at chunk ``j ^ (row %
    8)`` (the 128-byte swizzle a wgmma descriptor reads)."""
    k, n = w_in_out.shape
    t = w_in_out.to(torch.float32).t().reshape(n // 64, 64, k // 32, 32).permute(0, 2, 1, 3)
    t = t[..., list(F32_PANEL_ORDER)]
    hi = tf32_rna(t)
    tiles = torch.stack([hi, tf32_rna(t - hi)], 2).reshape(n // 64, k // 32, 2, 64, 8, 4)
    rows = torch.arange(64, device=t.device)
    src = torch.arange(8, device=t.device)[None, :] ^ (rows % 8)[:, None]
    return tiles[:, :, :, rows[:, None], src].reshape(n // 64, k // 32, 2, 64, 32).contiguous()


def weight_blocks_f32(p: Dict) -> torch.Tensor:
    """The fp32 kernel's weights (``csrc/motion_module_f32.cu``): for each
    consumer warpgroup cs < nsplit (``F32_PLAN``), the ``f32_tiles`` blocks
    it takes, in the order it takes them, one sequence after another, each
    block its hi tile then its lo tile.  A warpgroup takes: proj_in's
    output blocks n = cs, cs + nsplit, ... (each over all its input
    panels); per attention block and chunk of ``chunk_channels`` (whole
    heads), its blocks n ≡ cs (mod nsplit) of the chunk's q, k, v (n = 0,
    1, 2; q, k and v columns padded to 64 with zero columns), then its
    output blocks of the chunk's w_o rows (padded to 64 with zero rows);
    per feed-forward step f the h columns of hidden chunk f·nsplit + cs,
    their gate columns, then its output blocks of w2's rows of the step's
    nsplit chunks; proj_out."""
    c = p["w_in"].shape[0]
    ns = F32_PLAN[c][0]
    nch = chunk_channels(c)
    f32 = lambda w: w.to(torch.float32)  # noqa: E731
    seqs = [[] for _ in range(ns)]

    def out_blocks(tiles, cs):  # a warpgroup's output blocks, each over all panels
        return [tiles[n, kp] for n in range(cs, tiles.shape[0], ns) for kp in range(tiles.shape[1])]

    def padded(w, rows, cols):
        out = w.new_zeros(rows, cols)
        out[:w.shape[0], :w.shape[1]] = w
        return out

    for cs in range(ns):
        seqs[cs] += out_blocks(f32_tiles(p["w_in"]), cs)
    for i in range(p["wq"].shape[0]):
        for ch in range(c // nch):
            cols = slice(ch * nch, (ch + 1) * nch)
            qkv = [f32_tiles(padded(f32(p[k][i])[:, cols], c, 64)) for k in ("wq", "wk", "wv")]
            wo = f32_tiles(padded(f32(p["wo"][i])[cols], 64, c))
            for cs in range(ns):
                for n in range(cs, 3, ns):
                    seqs[cs] += list(qkv[n][0])
                seqs[cs] += out_blocks(wo, cs)
    w1, w2 = f32(p["w1"]), f32(p["w2"])
    for f in range(4 * c // (64 * ns)):
        w2t = f32_tiles(w2[f * ns * 64:(f + 1) * ns * 64])
        for cs in range(ns):
            j0 = (f * ns + cs) * 64
            seqs[cs] += list(f32_tiles(w1[:, j0:j0 + 64])[0])
            seqs[cs] += list(f32_tiles(w1[:, 4 * c + j0:4 * c + j0 + 64])[0])
            seqs[cs] += out_blocks(w2t, cs)
    for cs in range(ns):
        seqs[cs] += out_blocks(f32_tiles(p["w_out"]), cs)
    return torch.cat([torch.stack(sq).reshape(-1) for sq in seqs])


def f32_weight_blocks(c: int, heads: int = 8) -> int:
    """Blocks (hi and lo tiles, 4096 floats) of ``weight_blocks_f32`` at C."""
    ns = F32_PLAN[c][0]
    kp, nsw, nchk, fs = c // 32, c // 64 // ns, c // chunk_channels(c, heads), 4 * c // (64 * ns)
    return sum(2 * nsw * kp + 2 * nchk * (len(range(cs, 3, ns)) * kp + 2 * nsw)
               + fs * (2 * kp + 2 * ns * nsw) for cs in range(ns))


def chunk_channels(c: int, heads: int = 8) -> int:
    """Channels of one q/k/v chunk of the fp32 kernel: whole heads, at most
    64."""
    d = c // heads
    return d * (64 // d)


# The chain of csrc/motion_module_wide.cu (both dtypes): the rows of a GEMM
# tile, and the row blocks of a group of the persistent tile walk
# (``wide_tile``; the source's kGroupM).
WIDE_BM, WIDE_GROUP_M = 128, 8


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def wide_bn(n: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Output columns of the wide chain's GEMM tile for a product of ``n``
    columns (the source's ``bn_of``): 256 in bf16 (two consumer warpgroups on
    wgmma m64n256) where N > 128, else 128 (fp32 always: its hi and lo weight
    tiles leave no room for 256 beside the ring)."""
    return 256 if dtype == torch.bfloat16 and n > 128 else 128


def wide_hidden(p: Dict, dtype: torch.dtype = torch.bfloat16) -> int:
    """The wide chain's hidden units F in ``dtype``: ff_mult·C (w1's columns
    / 2) rounded up to a multiple of 64, then of half the GEGLU tile (128
    where that tile is 256 columns wide), so that every tile holds whole
    units' h and gate columns."""
    f = _round_up(p["w1"].shape[1] // 2, 64)
    return _round_up(f, wide_bn(2 * f, dtype) // 2)


def wide_products(p: Dict, dtype: torch.dtype = torch.bfloat16) -> list:
    """The ``(K, N)`` JAX-layout weights of the wide chain's products, in
    launch order: proj_in; per attention block ``[wq | wk | wv]`` (one
    product of 3C columns) and wo; w1 with each U hidden units' h columns
    followed by their U gate columns (U = half the GEGLU tile, so that a
    tile holds both halves of U activations), the hidden units padded with
    zero columns to F = ``wide_hidden``; w2 with zero rows past ff_mult·C;
    proj_out."""
    c, f = p["w_in"].shape[0], p["w1"].shape[1] // 2
    fp = wide_hidden(p, dtype)
    u = wide_bn(2 * fp, dtype) // 2
    out = [p["w_in"]]
    for i in range(p["wq"].shape[0]):
        out += [torch.cat([p["wq"][i], p["wk"][i], p["wv"][i]], dim=1), p["wo"][i]]
    w1 = F.pad(p["w1"].reshape(c, 2, f), (0, fp - f))
    w1 = w1.reshape(c, 2, fp // u, u).permute(0, 2, 1, 3).reshape(c, 2 * fp)
    return out + [w1, F.pad(p["w2"], (0, 0, 0, fp - f)), p["w_out"]]


def wide_b1(p: Dict, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """b1 as the wide chain's GEGLU epilogue reads it: fp32 ``(2F,)``, the h
    biases then the gate biases, each padded with zeros to F."""
    f, fp = p["w1"].shape[1] // 2, wide_hidden(p, dtype)
    return F.pad(p["b1"].to(torch.float32).reshape(2, f), (0, fp - f)).reshape(-1).contiguous()


def _pad_to(w: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """``w (K, N)`` padded with zero rows and columns to a multiple of ``k``
    rows and ``n`` columns."""
    return F.pad(w, (0, _round_up(w.shape[1], n) - w.shape[1], 0, _round_up(w.shape[0], k) - w.shape[0]))


def wide_tiles(w_in_out: torch.Tensor) -> torch.Tensor:
    """``(K, N)`` weight → bf16 ``(⌈N/BN⌉, ⌈K/64⌉, BN, 64)``, BN =
    ``wide_bn(N)``: for each BN-wide column block and 64-input panel, the
    K-major tile (output column n's inputs in a 128-byte row, its 16-byte
    chunk j at chunk ``j ^ (n % 8)``) that one bulk copy lands as a wgmma B
    operand; zeros past K and N."""
    bn = wide_bn(w_in_out.shape[1])
    w_in_out = _pad_to(w_in_out, 64, bn)
    k, n = w_in_out.shape
    t = sw128_tiles(w_in_out, rows=bn).reshape(k // 64, n // bn, bn, 64)
    return t.transpose(0, 1).contiguous()


def wide_tiles_f32(w_in_out: torch.Tensor) -> torch.Tensor:
    """``(K, N)`` weight → fp32 ``(⌈N/128⌉, ⌈K/32⌉, 2, 128, 32)``: per column
    block and 32-input panel the 3xTF32 split (hi = rna(w), lo = rna(w −
    hi)) as two K-major tiles in natural input order, output column n's
    16-byte chunk j at chunk ``j ^ (n % 8)``; zeros past K and N."""
    bn = wide_bn(w_in_out.shape[1], torch.float32)
    w_in_out = _pad_to(w_in_out.to(torch.float32), 32, bn)
    k, n = w_in_out.shape
    t = w_in_out.t().reshape(n // bn, bn, k // 32, 32).permute(0, 2, 1, 3)
    hi = tf32_rna(t.contiguous())
    tiles = torch.stack([hi, tf32_rna(t - hi)], 2).reshape(n // bn, k // 32, 2, bn, 8, 4)
    rows = torch.arange(bn, device=t.device)
    src = torch.arange(8, device=t.device)[None, :] ^ (rows % 8)[:, None]
    return tiles[:, :, :, rows[:, None], src].reshape(n // bn, k // 32, 2, bn, 32).contiguous()


def weight_blocks_wide(p: Dict, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The wide chain's weights: every product's ``wide_tiles`` (bf16) or
    ``wide_tiles_f32`` (fp32), in launch order, one flat sequence (at two
    attention blocks, ff_mult 4 and C a multiple of 256: 22 C² bf16 values,
    or 44 C² floats: hi and lo)."""
    tiles = wide_tiles if dtype == torch.bfloat16 else wide_tiles_f32
    return torch.cat([tiles(w).reshape(-1) for w in wide_products(p, dtype)])


def wide_weight_elems(c: int, n_attn: int, hidden: int, dtype: torch.dtype) -> int:
    """Elements of ``weight_blocks_wide`` for a module of width ``c``,
    ``n_attn`` attention blocks and ``hidden`` (padded) units."""
    kw, per = (64, 1) if dtype == torch.bfloat16 else (32, 2)
    shapes = [(c, c)] + [(c, 3 * c), (c, c)] * n_attn + [(c, 2 * hidden), (hidden, c), (c, c)]
    return sum(-(-n // wide_bn(n, dtype)) * -(-k // kw) * wide_bn(n, dtype) * kw * per
               for k, n in shapes)


def wide_tile(tile: int, nm: int, nn: int) -> tuple:
    """``(row block, column block)`` of output tile ``tile`` of a product
    with ``nm`` row blocks and ``nn`` column blocks, in the persistent walk's
    grouped order (the source's ``tile_coords``): groups of
    ``WIDE_GROUP_M`` row blocks (the last group ragged), column block after
    column block within a group, the group's rows before the next column,
    so that one wave of CTAs reads a few A panels and weight column blocks.
    Pure."""
    per_group = WIDE_GROUP_M * nn
    group, r = divmod(tile, per_group)
    first = group * WIDE_GROUP_M
    rows = min(nm - first, WIDE_GROUP_M)
    return first + r % rows, r // rows


def wide_schedule(m: int, n: int, bn: int, ctas: int) -> list:
    """The persistent GEMM's walk over an ``(m, n)`` output of ``bn``-wide
    tiles on ``ctas`` CTAs (the grid: at most one an SM): CTA b's list of
    ``(row block, column block)``, tiles b, b + ctas, ... in ``wide_tile``'s
    order.  Pure."""
    nm, nn = -(-m // WIDE_BM), -(-n // bn)
    grid = min(ctas, nm * nn)
    return [[wide_tile(t, nm, nn) for t in range(b, nm * nn, grid)] for b in range(grid)]


def wide_scratch_elems(m: int, c: int, hidden: int) -> int:
    """The wide chain's scratch, elements of x's dtype for ``m`` token rows:
    y and h rows of C rounded up to 8, and q | k | v rows of 3C rounded up to
    8 or FF rows of ``hidden``, whichever is wider."""
    return m * (2 * _round_up(c, 8) + max(_round_up(3 * c, 8), hidden))


_fns = {}


_fns = {}


def _kernel(name: str = "motion_module", symbol: Optional[str] = None):
    """``vda_<symbol>`` (``symbol`` = name unless given) of
    ``csrc/<name>.cu``: the launch (``motion_module``), the split
    (``motion_module_split<C>``: ``motion_module_split_<C>``), the fp32
    launch (``motion_module_f32``) or the
    wide chain (``motion_module_wide``: ``motion_module_wide``,
    ``motion_module_wide_f32`` and its split ``motion_module_wide_split``)."""
    symbol = symbol or name
    if symbol not in _fns:
        fn = getattr(cuda_build.library(name), f"vda_{symbol}")
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp] * 13 + [i, i, i, i, f, f, vp]
        if name.startswith("motion_module_split"):
            fn.argtypes += [i, vp]
        if name == "motion_module_wide":
            fn.argtypes += [vp, i, i, i]
            if symbol.endswith("_split"):
                fn.argtypes += [i, i, vp]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return _fns[symbol]


# The widths of the resident kernels, csrc/motion_module.cu's and _f32.cu's
# instantiations (vits m0 192, m1-m3 64; vitb m2/m3 128, m0 on 16:9 frames
# 384; vitl m2/m3 256), at 8 heads, two attention blocks and ff_mult 4.
RESIDENT_C = (64, 128, 192, 256, 384)
# Kernel operands after x, gna and gnb, in the C entry point's order.
_OPERANDS = ("pe", "w", "b_in", "ln_scale", "ln_bias", "bo", "b1", "b2", "b_out")


def resident(c: int, heads: int, cfg: MotionModuleConfig) -> bool:
    """Whether a module of width ``c`` takes the resident kernel (else the
    wide chain)."""
    return (heads == 8 and c in RESIDENT_C and cfg.num_attention_blocks == 2
            and cfg.ff_mult == 4)


def kernel_takes(shape, cfg: MotionModuleConfig, heads: int, dtype) -> bool:
    """Whether Kernel C takes ``x (B, T, S, C)`` of ``dtype`` through a
    module of ``cfg`` at ``heads`` heads: bf16 or fp32, one transformer
    block with APE, at least one attention block, whole heads, an even C or
    one below 64 (the gate admits odd C only up to 7), and 8 ≤ T ≤ 32
    within the APE table.  The resident kernel takes its five widths
    (``resident``), the wide chain everything else.  Pure: no card
    needed."""
    if len(shape) != 4 or dtype not in (torch.bfloat16, torch.float32):
        return False
    _, t, _, c = shape
    return (cfg.num_transformer_blocks == 1 and cfg.pos_embedding_type == "ape"
            and cfg.num_attention_blocks >= 1 and cfg.ff_mult >= 1 and heads >= 1
            and c % heads == 0 and (c % 2 == 0 or c < 64)
            and 8 <= t <= min(32, cfg.temporal_max_len))


def kernel_weights(p: Dict, cfg: MotionModuleConfig,
                   dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Kernel C's operands that depend only on the parameters, for inputs of
    ``dtype``: in bf16 the weight tiles in the order the kernel streams
    them (``weight_blocks``; ``weight_blocks_wide`` off the resident
    kernels' domain, with b1 as ``wide_b1``) and
    the bf16 APE table, in fp32 the fp32 kernel's hi and lo blocks
    (``weight_blocks_f32``; ``weight_blocks_wide`` in fp32) and the fp32 table (both
    under ``"w"`` and ``"pe"``, ``temporal_max_len`` rows); fp32 biases and
    norm parameters; on the parameters' device.  A caller that runs the
    module more than once builds this once (``TemporalModule`` caches it
    by dtype)."""
    c = p["w_in"].shape[0]
    f32 = lambda v: v.to(torch.float32).contiguous()  # noqa: E731
    w = {k: f32(p[k]) for k in ("gn_scale", "gn_bias", "b_in", "ln_scale", "ln_bias", "bo",
                                "b1", "b2", "b_out")}
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"motion_module kernels take bf16 or fp32, got {dtype}")
    if not resident(c, cfg.num_heads, cfg):
        w["w"] = weight_blocks_wide(p, dtype)
        w["b1"] = wide_b1(p, dtype).to(p["w_in"].device)
    else:
        w["w"] = weight_blocks(p) if dtype == torch.bfloat16 else weight_blocks_f32(p)
    w["pe"] = torch.from_numpy(sinusoidal_position_table(cfg.temporal_max_len, c)).to(
        p["w_in"].device, dtype)
    return w


def fused_motion_module(x: torch.Tensor, p: Optional[Dict], cfg: MotionModuleConfig,
                        heads: int, weights: Optional[Dict[str, torch.Tensor]] = None):
    """``(B, T, S, C)`` → whole motion module output.  CPU tensors take the
    plain version of the raw parameters ``p``; CUDA tensors launch Kernel C
    (its fp32 kernel on fp32 x) or raise.  ``weights`` is
    ``kernel_weights(p, cfg, x.dtype)``, built here from ``p`` when not
    given."""
    cuda_build.no_history("fused_motion_module", x, *(p or {}).values())
    if x.device.type == "cpu":
        return motion_module_plain(x, p, cfg, heads)
    w = kernel_weights(p, cfg, x.dtype) if weights is None else weights
    gna, gnb = gn_fold(x, w, cfg)
    return motion_module_launch(x, gna, gnb, w, cfg, heads)


def padded_frames(t: int) -> int:
    """The rows a location takes in Kernel C: T padded up to 8, 16 or 32
    (``padded_frames`` of ``csrc/motion_module.cuh``); its rows t >= T are
    zero, masked as keys and never stored."""
    if not 8 <= t <= 32:
        raise ValueError(f"Kernel C takes 8 <= T <= 32, got {t}")
    return 8 if t <= 8 else 16 if t <= 16 else 32


def _launch_args(x, gna, gnb, w, cfg, heads):
    b, t, s, c = x.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"motion_module kernel takes bf16 or fp32, got {x.dtype}")
    if w["w"].dtype != x.dtype or w["pe"].dtype != x.dtype:
        raise ValueError(f"motion_module weights are not kernel_weights for {x.dtype}")
    if not kernel_takes(x.shape, cfg, heads, x.dtype) or t > w["pe"].shape[0]:
        raise NotImplementedError(
            f"motion_module kernel takes one transformer block of APE attention blocks, whole "
            f"heads and 8 <= T <= 32 within the APE table; got heads={heads}, C={c}, T={t}, "
            f"{cfg.num_transformer_blocks} transformer block(s) of "
            f"{cfg.num_attention_blocks} attention block(s), {cfg.pos_embedding_type}")
    if resident(c, heads, cfg):
        n_w = 22 * c * c if x.dtype == torch.bfloat16 else 4096 * f32_weight_blocks(c)
    else:
        n_w = wide_weight_elems(c, cfg.num_attention_blocks, w["b1"].numel() // 2, x.dtype)
    if w["w"].numel() != n_w:
        raise ValueError(f"motion_module weights are not kernel_weights of a C = {c} module "
                         f"at {heads} heads and {cfg.num_attention_blocks} attention blocks")
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("motion_module needs a 16-byte aligned input")
    args = [x, gna, gnb] + [w[k] for k in _OPERANDS]
    cuda_build.no_history("motion_module_launch", *args)
    if any(a.device != x.device for a in args):
        raise ValueError("motion_module operands must share x's device")
    out = torch.empty_like(x)
    return out, x, (*(cuda_build.ptr(a) for a in args), cuda_build.ptr(out), b, t, s, c,
                 float((c // heads) ** -0.5), float(cfg.layer_norm_eps), cuda_build.stream_of(x))


def motion_module_launch(x: torch.Tensor, gna: torch.Tensor, gnb: torch.Tensor,
                         w: Dict[str, torch.Tensor], cfg: MotionModuleConfig, heads: int):
    """Kernel C's launch alone, given the folded GroupNorm (``gn_fold``) and
    ``kernel_weights`` for x's dtype; counts on
    ``fused_motion_module.launches`` (bf16) or ``f32_launches`` (fp32), off
    the resident kernels' domain on ``wide_launches`` or
    ``wide_f32_launches`` (the chain: one count a module)."""
    out, _x, args = _launch_args(x, gna, gnb, w, cfg, heads)  # _x: alive until enqueued
    c = x.shape[-1]
    if not resident(c, heads, cfg):
        hidden = w["b1"].numel() // 2
        # y, h and q|k|v / the FF activation of the chain
        scratch = torch.empty(wide_scratch_elems(x.numel() // c, c, hidden), dtype=x.dtype,
                              device=x.device)
        f32 = x.dtype == torch.float32
        symbol = "motion_module_wide_f32" if f32 else "motion_module_wide"
        cuda_build.check(_kernel("motion_module_wide", symbol)(
            *args, cuda_build.ptr(scratch), heads, cfg.num_attention_blocks, hidden), symbol)
        if f32:
            fused_motion_module.wide_f32_launches += 1
        else:
            fused_motion_module.wide_launches += 1
        return out
    if x.dtype == torch.float32:
        cuda_build.check(_kernel("motion_module_f32")(*args), "motion_module (fp32)")
        fused_motion_module.f32_launches += 1
    else:
        cuda_build.check(_kernel()(*args), "motion_module")
        fused_motion_module.launches += 1
    return out


SPLIT_STAGES = ("gn_apply", "proj_in", "attn1_qkv", "attn1_attention", "attn1_out", "attn2",
                "ff", "proj_out")
SPLIT_C = (64, 128, 256, 384)  # the widths of csrc/motion_module_split<C>.cu


def motion_module_split(x, gna, gnb, w, cfg, heads, iters: int = 20) -> dict:
    """Kernel C's time by stage (``csrc/motion_module_split<C>.cu``): from CUDA
    events around ``iters`` launches of instantiations that stop after each
    stage of ``SPLIT_STAGES`` (each writes its current activation rows
    out), the mean ms of each stage as the difference of successive stops,
    plus ``whole``.  C in ``SPLIT_C``, bf16; not counted as launches."""
    if x.dtype != torch.bfloat16:
        raise TypeError("the split instantiations are the bf16 kernel's")
    if x.shape[-1] not in SPLIT_C or not resident(x.shape[-1], heads, cfg):
        raise NotImplementedError(f"the split instantiations take C in {SPLIT_C} at the "
                                  f"resident kernel's config")
    _, _x, args = _launch_args(x, gna, gnb, w, cfg, heads)
    ms = (ctypes.c_float * 8)()
    c = x.shape[-1]
    fn = _kernel(f"motion_module_split{c}", f"motion_module_split_{c}")
    cuda_build.check(fn(*args, iters, ms), "motion_module_split")
    out = {name: ms[k] - (ms[k - 1] if k else 0.0) for k, name in enumerate(SPLIT_STAGES)}
    out["whole"] = ms[7]
    return out


def wide_launch_names(n_attn: int) -> list:
    """The wide chain's launches in order: the GroupNorm apply, proj_in, per
    attention block its LayerNorm (+ APE), q | k | v, frame attention and out
    projection, the feed-forward's LayerNorm, GEGLU, w2 and proj_out."""
    out = ["gn", "proj_in"]
    for i in range(1, n_attn + 1):
        out += [f"ln{i}", f"qkv{i}", f"attn{i}", f"out{i}"]
    return out + ["ln_ff", "geglu", "w2", "proj_out"]


def motion_module_wide_split(x, gna, gnb, w, cfg, heads, iters: int = 20) -> dict:
    """The wide chain's time by launch (``vda_motion_module_wide_split``):
    CUDA events between its launches over ``iters`` runs after a warm one,
    the mean ms of each launch of ``wide_launch_names``.  Off the resident
    domain, either dtype; not counted as launches."""
    c = x.shape[-1]
    if resident(c, heads, cfg):
        raise NotImplementedError("the wide chain's split takes modules off the resident domain")
    _, _x, args = _launch_args(x, gna, gnb, w, cfg, heads)
    hidden = w["b1"].numel() // 2
    scratch = torch.empty(wide_scratch_elems(x.numel() // c, c, hidden), dtype=x.dtype,
                          device=x.device)
    ms = (ctypes.c_float * 64)()
    fn = _kernel("motion_module_wide", "motion_module_wide_split")
    cuda_build.check(fn(*args, cuda_build.ptr(scratch), heads, cfg.num_attention_blocks, hidden,
                        int(x.dtype == torch.float32), iters, ms), "motion_module_wide_split")
    names = wide_launch_names(cfg.num_attention_blocks)
    return dict(zip(names, ms[:len(names)]))


fused_motion_module.launches = 0
fused_motion_module.f32_launches = 0
fused_motion_module.wide_launches = 0
fused_motion_module.wide_f32_launches = 0


class FusedMotionModuleFn(torch.autograd.Function):
    """Differentiable Kernel C: ``apply(x, cfg, heads, weights, names,
    *values)`` with the raw parameters ``dict(zip(names, values))`` and
    ``weights`` their ``kernel_weights`` (or None: built from them)."""

    @staticmethod
    def forward(ctx, x, cfg, heads, weights, names, *values):
        ctx.save_for_backward(x, *values)
        ctx.cfg, ctx.heads, ctx.names = cfg, heads, names
        return fused_motion_module(x, dict(zip(names, values)), cfg, heads, weights)

    @staticmethod
    def backward(ctx, g):
        def plain(x, *values):
            return motion_module_plain(x, dict(zip(ctx.names, values)), ctx.cfg, ctx.heads)

        needs = (ctx.needs_input_grad[0],) + ctx.needs_input_grad[5:]
        dx, *dvalues = recompute_vjp(plain, ctx.saved_tensors, needs, g)
        return (dx, None, None, None, None, *dvalues)
