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

Bound on the H100: tensor-core FLOPs (~44·C² per token); the fp32
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


_fns = {}


def _kernel(name: str = "motion_module"):
    """``vda_<name>`` of ``csrc/<name>.cu``: the launch (``motion_module``),
    the split (``motion_module_split``) or the fp32 launch
    (``motion_module_f32``)."""
    if name not in _fns:
        fn = getattr(cuda_build.library(name), f"vda_{name}")
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp] * 13 + [i, i, i, i, f, f, vp]
        if name == "motion_module_split":
            fn.argtypes += [i, vp]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


# The instantiations of csrc/motion_module.cu: the widths the gate sends
# here on vits (m0 192, m1-m3 64), vitb (m2/m3 128, m0 on 16:9 frames 384)
# and vitl (m2/m3 256).
_SUPPORTED_C = (64, 128, 192, 256, 384)
# Kernel operands after x, gna and gnb, in the C entry point's order.
_OPERANDS = ("pe", "w", "b_in", "ln_scale", "ln_bias", "bo", "b1", "b2", "b_out")


def kernel_weights(p: Dict, cfg: MotionModuleConfig,
                   dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Kernel C's operands that depend only on the parameters, for inputs of
    ``dtype``: in bf16 the weight tiles in the order the kernel streams
    them (``weight_blocks``) and the bf16 APE table, in fp32 the fp32
    kernel's hi and lo blocks (``weight_blocks_f32``) and the fp32 table (both
    under ``"w"`` and ``"pe"``, ``temporal_max_len`` rows); fp32 biases and
    norm parameters; on the parameters' device.  A caller that runs the
    module more than once builds this once (``TemporalModule`` caches it
    by dtype)."""
    c = p["w_in"].shape[0]
    f32 = lambda v: v.to(torch.float32).contiguous()  # noqa: E731
    w = {k: f32(p[k]) for k in ("gn_scale", "gn_bias", "b_in", "ln_scale", "ln_bias", "bo",
                                "b1", "b2", "b_out")}
    if dtype == torch.float32:
        w["w"] = weight_blocks_f32(p)
    elif dtype == torch.bfloat16:
        w["w"] = weight_blocks(p)
    else:
        raise TypeError(f"motion_module kernels take bf16 or fp32, got {dtype}")
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
    if c not in _SUPPORTED_C:
        raise NotImplementedError(
            f"motion_module kernel has no instantiation at C = {c} (it takes C in "
            f"{_SUPPORTED_C}); VDA_FUSED_MOTION=1 sends vitb m1 (768) and vitl m0/m1 (1024) "
            f"here: their widths are queued in ROADMAP Queue 2 B5")
    if heads != 8 or not 8 <= t <= 32 or t > w["pe"].shape[0]:
        raise NotImplementedError(
            f"motion_module kernel takes 8 heads, C in {_SUPPORTED_C}, 8 <= T <= 32 within "
            f"the APE table; got heads={heads}, C={c}, T={t}")
    if cfg.num_attention_blocks != 2 or cfg.num_transformer_blocks != 1:
        raise NotImplementedError("motion_module kernel takes one block of two attentions")
    if w["w"].numel() != (22 * c * c if x.dtype == torch.bfloat16 else 4096 * f32_weight_blocks(c)):
        raise ValueError(f"motion_module weights are not kernel_weights of a C = {c} module")
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
    ``fused_motion_module.launches`` (bf16) or ``f32_launches`` (fp32)."""
    out, _x, args = _launch_args(x, gna, gnb, w, cfg, heads)  # _x: alive until enqueued
    if x.dtype == torch.float32:
        cuda_build.check(_kernel("motion_module_f32")(*args), "motion_module (fp32)")
        fused_motion_module.f32_launches += 1
    else:
        cuda_build.check(_kernel()(*args), "motion_module")
        fused_motion_module.launches += 1
    return out


SPLIT_STAGES = ("gn_apply", "proj_in", "attn1_qkv", "attn1_attention", "attn1_out", "attn2",
                "ff", "proj_out")
SPLIT_C = (64, 128, 256, 384)  # the widths csrc/motion_module_split.cu instantiates


def motion_module_split(x, gna, gnb, w, cfg, heads, iters: int = 20) -> dict:
    """Kernel C's time by stage (``csrc/motion_module_split.cu``): from CUDA
    events around ``iters`` launches of instantiations that stop after each
    stage of ``SPLIT_STAGES`` (each writes its current activation rows
    out), the mean ms of each stage as the difference of successive stops,
    plus ``whole``.  C in ``SPLIT_C``, bf16; not counted as launches."""
    if x.dtype != torch.bfloat16:
        raise TypeError("the split instantiations are the bf16 kernel's")
    _, _x, args = _launch_args(x, gna, gnb, w, cfg, heads)
    ms = (ctypes.c_float * 8)()
    cuda_build.check(_kernel("motion_module_split")(*args, iters, ms), "motion_module_split")
    out = {name: ms[k] - (ms[k - 1] if k else 0.0) for k, name in enumerate(SPLIT_STAGES)}
    out["whole"] = ms[7]
    return out


fused_motion_module.launches = 0
fused_motion_module.f32_launches = 0


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
