"""Kernel B: temporal attention core (``csrc/temporal_attention.cu``, and on
fp32 operands ``csrc/temporal_attention_f32.cu``; at the other head widths
``csrc/temporal_attention_any.cu`` in bf16 and
``csrc/temporal_attention_any_f32.cu`` in fp32).

Replaces ``video_depth_anything_tpu/ops/pallas_temporal.py``
``_temporal_kernel`` (``temporal_attention_window``) at every (T ≤ 32, C,
heads) the JAX gate admits.  The head widths of the shipped encoders, d ∈
{8, 16, 24, 32, 48, 128} at C ≤ 1024, take the instantiated kernels; every
other width the gate admits (with location packing d = 1 … 7, 10, 12, 14,
20, 28, 40, 56, 64, 80, 96, 112 and, at one or two heads, up to 512;
without it d = 64, and d = 128 at C = 2048) takes a run-time-d kernel:
``temporal_attention_any.cu`` in bf16, ``temporal_attention_any_f32.cu``
in fp32, whose geometry ``any_f32_plan`` gives.  ``kernel_takes`` is the
kernels' domain, a pure predicate.  ``temporal_gate`` is the JAX
dispatch rule of ``try_temporal_attention`` (``pallas_temporal.py:277-313``):
the lane-packing constraints of the TPU kernel and, under ``auto``, head_dim
≤ 24.  Under ``auto`` that is, at 518², vits m0 (C = 192, d = 24) and m2
(C = 64, d = 8) and vitb m2 (C = 128, d = 16); the KV-streaming warm-up
(no fused module) also sends vits m0/m2/m3 and vitb m2/m3 here at both
frame sizes.  ``auto=False`` (``--attn_impl pallas``) drops the d ≤ 24
rule and adds d = 32 (vitl m2), 48 (vits m1, vitb m0) and 128 (vitl m0,
m1).

``TemporalAttentionFn`` is the differentiable entry: Kernel B forward (the
plain version on CPU tensors) and ``temporal_attention_bwd_plain``, the
port of the JAX custom VJP ``_attention_bwd_math``
(``pallas_temporal.py:117-145``), backward.  ``temporal_attention`` is the
raw launch and keeps no autograd history.  ``tile_plan`` is the kernel's
tile geometry (locations and heads per tile), which
``tests/test_torch_temporal_tiling.py`` emulates on the CPU; the fp32
kernel's tiles are the same plan reckoned at 4-byte elements.
``temporal_attention.launches`` counts the bf16 kernel's launches,
``f32_launches`` the fp32 kernel's: the JAX kernel on fp32 inputs (its
gate checks no dtype; the probabilities stay fp32), FFMA in fp32 fed from
registers, the same widths and the bf16 kernel's pipelined walk over a
ring of tiles; ``any_launches`` and ``any_f32_launches`` count the
run-time-d kernel's.  ``width_launches`` and ``f32_width_launches`` count
each dtype's launches by head width, over both kernels.

Bound on the H100: memory bytes (q, k, v read once, out written once).
"""

from __future__ import annotations

import ctypes

import torch

from video_depth_anything_torch.ops import cuda_build

_LANES = 128


def _auto_pack(c: int, heads: int) -> int:
    p = max(1, min(_LANES // heads, 1024 // c))
    while p > 1 and (p * c) % _LANES != 0:
        p -= 1
    return p


def temporal_gate(shape, heads: int, auto: bool = True) -> bool:
    """True where the JAX package sends ``(B, T, S, C)`` to the Pallas
    temporal kernel: ``auto`` is JAX's argument (``--attn_impl auto``);
    ``auto=False`` (``pallas``) drops the head_dim ≤ 24 rule."""
    if len(shape) != 4:
        return False
    _, t, _, c = shape
    if c % heads or t < 8:
        return False
    d = c // heads
    pack = _auto_pack(c, heads)
    if (pack * c) % _LANES:
        return False
    if pack == 1 and (c % _LANES or d not in (32, 64, 128)):
        return False
    return d <= 24 or not auto


def temporal_attention_plain(q, k, v, heads: int, scale: float) -> torch.Tensor:
    """Per-location attention over the frame axis of ``(B, T, S, C)``:
    fp32 scores and softmax, bf16 (input-dtype) probabilities, fp32
    accumulate (``TemporalSelfAttention._attend`` in the JAX package)."""
    b, t, s, c = q.shape
    d = c // heads
    q5, k5, v5 = (x.reshape(b, x.shape[1], s, heads, d).float() for x in (q, k, v))
    scores = torch.einsum("bqshd,bkshd->bshqk", q5, k5) * scale
    probs = torch.softmax(scores, dim=-1).to(q.dtype).float()
    out = torch.einsum("bshqk,bkshd->bqshd", probs, v5)
    return out.to(q.dtype).reshape(b, t, s, c)


def temporal_attention_bwd_plain(q, k, v, g, heads: int, scale: float):
    """``(dq, dk, dv)`` of per-location frame attention: the einsum backward
    of the JAX package (``_attention_bwd_math``): fp32 scores, softmax and
    products; p rounded to g's dtype for dv, ds scaled then rounded to q's
    dtype; outputs in the inputs' dtypes."""
    b, t, s, c = q.shape
    d = c // heads
    q5, k5, v5, g5 = (x.reshape(b, t, s, heads, d) for x in (q, k, v, g))
    p = torch.softmax(torch.einsum("bqshd,bkshd->bshqk", q5.float(), k5.float()) * scale, dim=-1)
    dv = torch.einsum("bshqk,bqshd->bkshd", p.to(g.dtype).float(), g5.float()).to(v.dtype)
    dp = torch.einsum("bqshd,bkshd->bshqk", g5.float(), v5.float())
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True)) * scale).to(q.dtype).float()
    dq = torch.einsum("bshqk,bkshd->bqshd", ds, k5.float()).to(q.dtype)
    dk = torch.einsum("bshqk,bqshd->bkshd", ds, q5.float()).to(k.dtype)
    return tuple(x.reshape(b, t, s, c) for x in (dq, dk, dv))


_fns = {}
# The instantiations of csrc/temporal_attention.cu and _f32.cu, at C ≤
# 1024: every head width of the shipped encoders (vits 8/24/48, vitb 16/48,
# vitl 32/128).  Other widths take csrc/temporal_attention_any.cu.
_SUPPORTED_D = (8, 16, 24, 32, 48, 128)
_TILE_BYTES = 512  # bytes of a frame's run that a tile aims at
_SMEM_MAX = 227 * 1024  # shared memory a CTA may opt into on an H100


def tile_plan(c: int, heads: int, itemsize: int = 2) -> tuple:
    """``(locs, group)``: the adjacent locations and whole heads of one
    kernel tile, for elements of ``itemsize`` bytes.  In bf16 a tile takes
    every head while C ≤ 256 (then 256 / C locations: one 512-byte run a
    frame at C = 64, 128 and 256), else the largest head group of ≤ 256
    channels (C = 384: 4 heads of 48; C = 1024: 2 of 128) at one location;
    in fp32 the same rule at 128 channels."""
    channels = _TILE_BYTES // itemsize
    d = c // heads
    group = max(g for g in range(1, heads + 1)
                if heads % g == 0 and (g == 1 or g * d <= channels))
    locs = max(1, channels // c) if group == heads else 1
    return locs, group


def instantiated(c: int, heads: int) -> bool:
    """Whether ``(C, heads)`` takes the instantiated kernels (else the
    run-time-d one)."""
    return c // heads in _SUPPORTED_D and c <= 1024


def any_row_stride(c: int, heads: int, itemsize: int = 2) -> int:
    """The run-time-d kernel's shared row stride in floats: a tile's
    ``locs · group · d`` channels, plus V where that many V-wide reads
    would be even (V = 4, 2 or 1, the largest dividing d), so that 32 rows'
    reads hit distinct banks."""
    d = c // heads
    locs, group = tile_plan(c, heads, itemsize)
    vec = 4 if d % 4 == 0 else 2 if d % 2 == 0 else 1
    base = locs * group * d
    return base if (base // vec) % 2 else base + vec


SMS = 132  # an H100 SXM's SMs: the plan's small-batch rule on this card
_BOX_MAX = 256  # a TMA box's elements along one dimension
_MAX_SLOTS = 12  # the fp32 run-time-d kernel's ring slots at most
_BAR_BYTES = 2 * _MAX_SLOTS * 8 + 128  # its barriers and the ring's alignment
_SM_SMEM = 233472  # shared memory of one SM, 1 KB of it reserved a CTA


def any_f32_plan(shape, heads: int, sms: int = SMS) -> dict:
    """The fp32 run-time-d kernel's plan (``csrc/temporal_attention_any_f32.cu``
    computes the same from the same arguments) for ``(B, T, S, C)`` at
    ``heads`` heads on a card of ``sms`` SMs.

    Tiles: ``tile_plan`` at 4-byte elements (at most 128 channels: L
    adjacent locations where a tile holds every head, else a group of G
    whole heads), one location a tile where those tiles would not cover
    the SMs.  A tile's row of L·G·d floats a frame lands as ``nb`` boxes
    of ``bw`` floats (a multiple of 4 with bw / 4 odd, so that 16-byte
    reads of 8 adjacent frames hit 8 bank groups; the extra floats are the
    next channels, or zeros past the end, and are never read), box b from
    the row's column b·w: one box where the row fits in 256 floats, else
    ⌈row / 240⌉ boxes of w (a multiple of 16) + 4.  ``loader``: ``"tma"``
    (a 3-D tensor map (S·C, T, B) of the tensor, one box per tensor and
    box of the row on the stage's mbarrier) where the frame stride S·C·4
    bytes is a multiple of 16 and every box starts on a 16-byte boundary
    (a TMA box that does not faults: C and G·d multiples of 4), else
    ``"cp.async"`` (the consumer warps copy the rows 4 bytes at a time into
    the same ring: C = 1, 2, 3, 5, 6, 7, 10, 14 at one head, 2, 6, 10, 14
    at two).  ``kind`` (the consumer's width class): 0 at d ≤ 4 (a lane a
    whole query row, ``kl`` = 1: the unit 32 lanes of 32 / ``tp`` (location,
    head) pairs × ``tp`` query frames), 1 at d ≤ 32 (units of 32 query
    frames, ``kl`` = 4 lanes a row), 2 at d ≤ 64 (16, 4), 3 above (8, 8), 4
    (4, 8) where a one-head tile's CTA is alone on its SM; ``dc`` the P·V
    pass's columns.  Ring: ``slots`` slots and ``nw`` consumer warps a CTA
    (one more, the producer, under TMA).  A slot is a tile (q, k and v:
    nb·32·bw floats each) with eight warps (class 0: up to sixteen) and
    four slots where a tile has 8 or more ``units`` and they fit, else up
    to four warps and two slots where two such CTAs fit on an SM; else
    (``split``) a slot is one tensor, q's and k's released after the
    scores, v's after P·V: up to four warps and up to six slots where two
    CTAs of two slots fit (d ≤ 384), else class 4's eight warps and as
    many slots (up to twelve) as fit in one CTA; under cp.async a multiple
    of three.  ``smem`` is a CTA's dynamic shared
    memory; ``None`` where no plan fits."""
    b, t, s, c = shape
    d = c // heads
    locs, group = tile_plan(c, heads, 4)
    hgroups = heads // group
    if locs > 1 and b * -(-s // locs) * hgroups < sms:
        locs = 1
    row = locs * group * d
    bw = -(-row // 4) * 4
    bw += 4 if (bw // 4) % 2 == 0 else 0
    if bw <= _BOX_MAX:
        nb, w = 1, bw
    else:
        nb = -(-row // (_BOX_MAX - 16))
        w = -(-(-(-row // nb)) // 16) * 16
        bw = w + 4
    loader = "tma" if c % 4 == 0 and (group * d) % 4 == 0 else "cp.async"
    kind = 0 if d <= 4 else 1 if d <= 32 else 2 if d <= 64 else 3
    vec = 4 if d % 4 == 0 else 2 if d % 2 == 0 else 1
    tp = 8 if t <= 8 else 16 if t <= 16 else 32
    qf = {1: 32, 2: 16, 3: 8, 4: 4}

    def count(k):  # a tile's units in class k
        return -(-(locs * group) // (32 // tp)) if k == 0 else locs * group * -(-t // qf[k])

    units = count(kind)
    tensor = nb * 32 * bw * 4  # one tensor's rows of a tile, bytes
    split = False
    if units >= 8 and _BAR_BYTES + 4 * 3 * tensor <= _SMEM_MAX:
        nw, slots = min(16, units) if kind == 0 else 8, 4
    elif 2 * (_BAR_BYTES + 2 * 3 * tensor + 1024) <= _SM_SMEM:
        nw, slots = min(4, units), 2
    else:  # a slot a tensor
        split = True
        if 2 * (_BAR_BYTES + 2 * tensor + 1024) <= _SM_SMEM:
            nw, slots = min(4, units), min(6, (_SM_SMEM // 2 - 1024 - _BAR_BYTES) // tensor)
        else:  # one CTA: class 4, eight warps on a one-head tile
            if kind == 3:
                kind, units = 4, count(4)
            nw, slots = min(8, units), min(_MAX_SLOTS, (_SMEM_MAX - _BAR_BYTES) // tensor)
        if loader == "cp.async":
            slots -= slots % 3
    if split:  # two slots only for one unit a warp (its v waits for its own q and k)
        fits = kind >= 3 and vec == 4 and slots >= (2 if loader == "tma" and units <= nw else 3)
    else:
        fits = slots >= 1
    fits = fits and (loader == "tma" or nb == 1)
    kl = 1 if kind == 0 else 8 if kind >= 3 else 4
    dc = {0: 4, 1: 8, 2: 16, 3: 16, 4: 32}[kind]
    sblocks = -(-s // locs)
    return dict(locs=locs, group=group, row=row, bw=bw, nb=nb, w=w, loader=loader, kind=kind,
                kl=kl, tp=tp, dc=dc, units=units, nw=nw, split=split, slots=slots,
                tiles=b * sblocks * hgroups,
                smem=_BAR_BYTES + slots * (1 if split else 3) * tensor if fits else None)


def kernel_takes(shape, heads: int, dtype) -> bool:
    """Whether Kernel B takes ``(B, T, S, C)`` q, k and v of ``dtype`` at
    ``heads`` heads: bf16 or fp32, whole heads, 1 ≤ T ≤ 32, and (off the
    instantiated widths) the run-time-d kernel's tile: in bf16 3·T rows of
    ``any_row_stride`` floats within shared memory, in fp32 a plan
    (``any_f32_plan``).  Pure: no card needed."""
    if len(shape) != 4 or dtype not in (torch.bfloat16, torch.float32):
        return False
    _, t, _, c = shape
    if heads < 1 or c % heads or not 1 <= t <= 32:
        return False
    if instantiated(c, heads):
        return True
    if dtype == torch.float32:
        return any_f32_plan(shape, heads)["smem"] is not None
    return 3 * t * any_row_stride(c, heads, 2) * 4 <= _SMEM_MAX


def _kernel(name: str = "temporal_attention", symbol: str = ""):
    """``vda_<symbol>`` (``symbol`` = name unless given) of
    ``csrc/<name>.cu``: the bf16 kernel, ``temporal_attention_f32``,
    ``temporal_attention_any`` (and its split ``temporal_attention_any_split``),
    ``temporal_attention_any_f32`` (and ``temporal_attention_any_f32_split``)."""
    symbol = symbol or name
    if symbol not in _fns:
        fn = getattr(cuda_build.library(name), f"vda_{symbol}")
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, i, i, i, i, i, ctypes.c_float, i, i]
        fn.argtypes += [i, vp] if symbol == "temporal_attention" else [vp]
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return _fns[symbol]


def _checked(q, k, v, heads: int):
    """q, k and v as the kernel takes them, or raise."""
    t, c = q.shape[1], q.shape[-1]
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"temporal_attention kernel takes bf16 or fp32, got "
                        f"{(q.dtype, k.dtype, v.dtype)}")
    if not kernel_takes(q.shape, heads, q.dtype):
        raise NotImplementedError(
            f"temporal_attention kernel takes 1 <= T <= 32, whole heads and tile rows within "
            f"shared memory, got T={t}, C={c}, heads={heads}")
    q, k, v = (x.contiguous() for x in (q, k, v))
    for x in (k, v):
        if x.shape != q.shape or x.device != q.device:
            raise ValueError("q, k and v must share shape and device")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("temporal_attention needs 16-byte aligned tensors")
    return q, k, v


def _launch(q, k, v, heads: int, scale: float, stop: bool = False):
    b, t, s, c = q.shape
    locs, group = tile_plan(c, heads, q.element_size())
    out = torch.empty_like(q)
    args = (cuda_build.ptr(q), cuda_build.ptr(k), cuda_build.ptr(v), cuda_build.ptr(out),
            b, t, s, c, heads, float(scale), locs, group)
    if not instantiated(c, heads):
        name = "temporal_attention_any" + ("_f32" if q.dtype == torch.float32 else "")
        symbol = name + ("_split" if stop else "")
        err = _kernel(name, symbol)(*args, cuda_build.stream_of(q))
        cuda_build.check(err, symbol)
        return out
    if q.dtype == torch.float32:
        if stop:
            raise ValueError("the instantiated fp32 kernel has no split (copies only) build")
        err = _kernel("temporal_attention_f32")(*args, cuda_build.stream_of(q))
    else:
        err = _kernel()(*args, int(stop), cuda_build.stream_of(q))
    cuda_build.check(err, "temporal_attention")
    return out


def temporal_attention(q, k, v, heads: int, scale: float) -> torch.Tensor:
    """``(B, T, S, C)`` → ``(B, T, S, C)``, bf16 or fp32.  CPU tensors take
    the plain version; CUDA tensors launch Kernel B (its fp32 kernel on
    fp32 operands) or raise."""
    cuda_build.no_history("temporal_attention", q, k, v)
    if q.device.type == "cpu":
        return temporal_attention_plain(q, k, v, heads, scale)
    out = _launch(*_checked(q, k, v, heads), heads, scale)
    c, f = q.shape[-1], temporal_attention
    d = c // heads
    f32 = q.dtype == torch.float32
    if instantiated(c, heads):
        if f32:
            f.f32_launches += 1
        else:
            f.launches += 1
    elif f32:
        f.any_f32_launches += 1
    else:
        f.any_launches += 1
    widths = f.f32_width_launches if f32 else f.width_launches
    widths[d] = widths.get(d, 0) + 1
    return out


def temporal_attention_split(q, k, v, heads: int, scale: float) -> torch.Tensor:
    """Kernel B's copies in and out alone on CUDA tensors (the attention
    dropped, out = q): the split that ``bench_temporal`` times, of the
    instantiated bf16 kernel and of both run-time-d kernels.  Not counted
    in the launch counters."""
    return _launch(*_checked(q, k, v, heads), heads, scale, stop=True)


temporal_attention.launches = 0
temporal_attention.width_launches = {}  # bf16 launches by head width d, both kernels
temporal_attention.f32_launches = 0
temporal_attention.f32_width_launches = {}  # fp32 launches by head width d, both kernels
temporal_attention.any_launches = 0  # the run-time-d kernel's, bf16
temporal_attention.any_f32_launches = 0  # and fp32


class TemporalAttentionFn(torch.autograd.Function):
    """Differentiable Kernel B: ``apply(q, k, v, heads, scale)`` on
    ``(B, T, S, C)``; backward ``temporal_attention_bwd_plain``."""

    @staticmethod
    def forward(ctx, q, k, v, heads, scale):
        ctx.save_for_backward(q, k, v)
        ctx.heads, ctx.scale = heads, scale
        return temporal_attention(q, k, v, heads, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*temporal_attention_bwd_plain(q, k, v, g, ctx.heads, ctx.scale), None, None)
