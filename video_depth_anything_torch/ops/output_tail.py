"""The fused output tail of the DPT head (``csrc/output_tail.cu``).

Replaces ``video_depth_anything_tpu/ops/pallas_output_stack.py``
``_tail_kernel`` (``fused_output_tail``).  On ``output_conv1``'s map
``(N, H, W, C)`` it computes bilinear align_corners resize to
``(out_h, out_w)`` → conv3×3 C→32 + bias → ReLU → conv1×1 32→1 + bias →
ReLU, and writes only the ``(N, out_h, out_w, 1)`` depth.
``output_tail_plain`` is the same chain in plain PyTorch (``F.interpolate``
and ``F.conv2d``), what ``DPTHeadTemporal._output_head`` runs where the
gate says no, and the port of ``xla_output_tail``
(``pallas_output_stack.py:463``).

``output_tail_gate`` is the JAX dispatch rule (``models/dpt.py:172-233``
and ``try_fused_output_tail``): bf16, ``ModelConfig.fused_output_tail``
on, no packed small-channel output stack (of the shipped heads only
vitl's, C = 128, has none while ``packed_output_stack`` is on; with it off
vits' C = 32 and vitb's C = 64 reach the gate too), C in {32, 64, 128},
h, w ≥ 2, and the TPU kernel's VMEM estimate within its 97 MiB budget.
That admits the 518² windows and refuses 518×924.  ``kernel_takes`` is
the kernel's own domain (bf16, C in {32, 64, 128}, every tile's taps
within its source patch); the gate's shapes lie inside it.

Weights use the port's (the reference torch) layout: ``w1 (32, C, 3, 3)``,
``b1 (32,)``, ``w2 (1, 32, 1, 1)``, ``b2 (1,)``.

``OutputTailFn`` is the differentiable entry: the tail kernel forward (the
plain chain on CPU tensors) and the plain chain's gradient backward, as the
JAX VJP (``pallas_output_stack.py:547-552``).  ``output_tail`` is the raw
launch and keeps no autograd history.

Bound on the H100: tensor-core FLOPs (73,728 per output pixel at C = 128);
see the source.
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from video_depth_anything_torch.ops import cuda_build, resize
from video_depth_anything_torch.ops.dispatch import recompute_vjp
from video_depth_anything_torch.ops.motion_module import sw128_tiles
from video_depth_anything_torch.ops.resize import _linear_taps, bilinear_resize

_MID = 32  # output_conv2's hidden width, fixed by the architecture
_CHUNK = 256  # the TPU kernel's horizontal GEMM chunk (enters its VMEM estimate)
_VMEM_BUDGET = 97 * 1024 * 1024


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _s2d_profitable(cin: int, cout: int) -> bool:
    """The JAX rule for the 2×2 space-to-depth conv layout
    (``models/layers.py:65-74``): packing pays where it cuts the TPU's
    128-lane padding."""
    pad = lambda c: _round_up(c, 128)  # noqa: E731
    return pad(4 * cin) * pad(4 * cout) // 4 < pad(cin) * pad(cout)


def _packed_plan(cfg):
    """``DPTHeadTemporal._packed_plan``: None under
    ``packed_output_stack=False``, else "pre" (vits), "post" (vitb) or None
    (vitl); only None leaves the tail to the fused kernel."""
    if not cfg.packed_output_stack:
        return None
    features = cfg.features
    if _s2d_profitable(features, features // 2):
        return "pre"
    if _s2d_profitable(features // 2, _MID):
        return "post"
    return None


def _pick_row_block(out_h: int, top: int = 104) -> int:
    best = None
    for r in range(top, 31, -8):
        hr = -(-out_h // r) * r
        if best is None or hr < best[0] or (hr == best[0] and r > best[1]):
            best = (hr, r)
    return best[1]


def _row_span(in_h: int, out_h: int, r_blk: int) -> int:
    """Input rows the TPU kernel holds per row block (``_block_tables``)."""
    lo, hi, _, _ = _linear_taps(in_h, out_h)
    span = 0
    for rb in range(-(-out_h // r_blk)):
        first = lo[max(rb * r_blk - 1, 0)]
        last = hi[min(rb * r_blk + r_blk, out_h - 1)]
        span = max(span, int(last - first + 1))
    return min(span, in_h)


def _vmem_estimate(n: int, h: int, w: int, c: int, out_h: int, out_w: int) -> int:
    """The TPU kernel's VMEM estimate (``pallas_output_stack.py:558-570``)."""
    groups = {32: 4, 64: 2}.get(c, 1)
    if groups > 1 and n % groups:
        groups = 1
    r_blk = _pick_row_block(out_h)
    cl = max(groups * c, 128)
    r_sub = r_blk if r_blk <= 24 else -(-r_blk // 4)
    span = _row_span(h, out_h, r_blk)
    ws = _round_up(out_w + 2, 8)
    w2 = _round_up(max(ws + 8, 1 + max(out_w, _CHUNK)), 8)
    xbuf = span * _round_up(w, 8) * cl * 2
    h2 = span * w2 * cl * 4
    r2 = (r_blk + 2) * (w2 + 2 * ws) * cl * 2
    conv_tmp = 3 * (r_sub + 2) * ws * cl * 2 + 3 * (r_sub + 2) * ws * 128 * 4
    return xbuf + h2 + r2 + conv_tmp


def output_tail_gate(cfg, shape, dtype, out_h: int, out_w: int) -> bool:
    """True where the JAX package runs the fused Pallas tail on
    ``output_conv1``'s map of ``shape (N, H, W, C)``: never in fp32, under
    ``cfg.fp32_head_island`` or with ``cfg.fused_output_tail`` off (JAX
    ``models/dpt.py:202``).  The weight shapes
    the JAX gate also checks, ``(3, 3, C, 32)`` and 32, hold by
    construction when C is the head's ``features // 2``."""
    if (dtype != torch.bfloat16 or cfg.fp32_head_island or not cfg.fused_output_tail
            or len(shape) != 4 or _packed_plan(cfg) is not None):
        return False
    n, h, w, c = shape
    if c not in (32, 64, 128) or c != cfg.features // 2 or h < 2 or w < 2:
        return False
    return _vmem_estimate(n, h, w, c, out_h, out_w) <= _VMEM_BUDGET


def output_tail_plain(x, w1, b1, w2, b2, out_h: int, out_w: int,
                      fp32_island: bool = False) -> torch.Tensor:
    """``(N, H, W, C)`` → ``(N, out_h, out_w, 1)``: ``F.interpolate``
    (align_corners, fp32 arithmetic, one rounding to x's dtype), then
    ``F.conv2d`` twice with ReLUs, in x's dtype (in fp32 from the resized
    map on with ``fp32_island``, as JAX ``models/dpt.py:243-246``); in
    chunks of frames whose resized map stays within
    ``resize._MAX_ELEMENTS``."""
    n = max(1, resize._MAX_ELEMENTS // (out_h * out_w * x.shape[-1]))
    if x.shape[0] > n:
        return torch.cat([output_tail_plain(c, w1, b1, w2, b2, out_h, out_w, fp32_island)
                          for c in x.split(n)])
    y = bilinear_resize(x, out_h, out_w).permute(0, 3, 1, 2)
    if fp32_island:
        y = y.float()
    dt = y.dtype
    y = torch.relu(F.conv2d(y, w1.to(dt), b1.to(dt), padding=1))
    y = torch.relu(F.conv2d(y, w2.to(dt), b2.to(dt)))
    return y.permute(0, 2, 3, 1)


_fns = {}


def _kernel(name: str = "output_tail"):
    """``vda_<name>`` of ``csrc/output_tail.cu``: the launch, or the split."""
    if name not in _fns:
        fn = getattr(cuda_build.library("output_tail"), f"vda_{name}")
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 6 + [i] * 6 + [vp]
        if name == "output_tail_split":
            fn.argtypes += [i, vp]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


# The instantiations of csrc/output_tail.cu: the widths the JAX gate admits
# (vitl's head; vits' and vitb's without the packed output stack).
_SUPPORTED_C = (32, 64, 128)
# csrc/output_tail.cu's output tile (rows, columns) and the source patch
# (rows, columns) its taps must stay within.
_TILE = (8, 16)
_PATCH = (8, 12)


@functools.lru_cache(maxsize=64)
def _patch_span(in_size: int, out_size: int, tile: int) -> int:
    """The most source pixels the taps of one ``tile``-wide run of output
    pixels and its two halo pixels reach along one axis."""
    lo, hi, _, _ = _linear_taps(in_size, out_size)
    t0 = np.arange(0, out_size, tile)
    first = lo[np.maximum(t0 - 1, 0)]
    last = hi[np.minimum(t0 + tile, out_size - 1)]
    return int((last - first).max()) + 1


def conv_weight_tiles(w1: torch.Tensor) -> torch.Tensor:
    """``w1 (32, C, 3, 3)`` → the kernel's wgmma B tiles: K = 9·C in (dy,
    dx, c) order, padded with zero rows to a multiple of 64 (C = 32: 288 of
    320), ``sw128_tiles`` of 32 output channels × 64 inputs."""
    c = w1.shape[1]
    k = w1.permute(2, 3, 1, 0).reshape(9 * c, _MID)
    k = torch.cat([k, k.new_zeros(_round_up(9 * c, 64) - 9 * c, _MID)])
    return sw128_tiles(k, rows=_MID)


def kernel_takes(shape, dtype, out_h: int, out_w: int) -> bool:
    """Whether the tail kernel takes ``output_conv1``'s map of ``shape
    (N, H, W, C)`` resized to ``(out_h, out_w)``: bf16, C in
    ``_SUPPORTED_C``, and every tile's taps within its source patch.  Pure:
    no card needed."""
    if dtype != torch.bfloat16 or len(shape) != 4:
        return False
    _, h, w, c = shape
    return (c in _SUPPORTED_C and _patch_span(h, out_h, _TILE[0]) <= _PATCH[0]
            and _patch_span(w, out_w, _TILE[1]) <= _PATCH[1])


@functools.lru_cache(maxsize=16)
def _taps(in_size: int, out_size: int, device: torch.device):
    """Device tables of the align_corners taps: int32 ``[lo; hi]`` and fp32
    ``[w_lo; w_hi]``, each ``(2 * out_size,)``."""
    lo, hi, wlo, whi = _linear_taps(in_size, out_size)
    idx = torch.from_numpy(np.concatenate([lo, hi]).astype(np.int32)).to(device)
    wts = torch.from_numpy(np.concatenate([wlo, whi])).to(device)
    return idx, wts


@functools.lru_cache(maxsize=16)
def _tile_taps(in_size: int, out_size: int, tile: int, device: torch.device) -> torch.Tensor:
    """The kernel's tap table of one axis: int32 ``(tiles, tile + 3, 4)``,
    per tile the source patch origin (the low tap of its first halo pixel)
    in entry 0, then each halo pixel's ``(lo, hi, w_lo, w_hi)`` from
    ``_taps``, taps relative to the origin, the weights' fp32 bits; ``(-1,
    -1, 0, 0)`` past the map's edge."""
    idx, wts = (t.numpy() for t in _taps(in_size, out_size, torch.device("cpu")))
    lo, hi = idx[:out_size], idx[out_size:]
    wbits = wts.view(np.int32)
    tiles = -(-out_size // tile)
    tab = np.zeros((tiles, tile + 3, 4), np.int32)
    for t in range(tiles):
        org = lo[max(t * tile - 1, 0)]
        tab[t, 0, 0] = org
        for r in range(tile + 2):
            o = t * tile - 1 + r
            tab[t, 1 + r] = ((lo[o] - org, hi[o] - org, wbits[o], wbits[out_size + o])
                             if 0 <= o < out_size else (-1, -1, 0, 0))
    return torch.from_numpy(tab).to(device)


def cached_operands(slot: list, tensors, build):
    """``build()``, the kernel operands made from ``tensors``, kept in
    ``slot`` and made again only for other tensors or when one of them is
    written in place (its version moves), as ``TemporalModule`` keeps
    Kernel C's.  Weak references tell the same tensors from new ones at a
    reused address."""
    versions = tuple(t._version for t in tensors)
    if slot:
        refs, vers, ops = slot[0]
        if vers == versions and all(r() is t for r, t in zip(refs, tensors)):
            return ops
    ops = build()
    slot[:] = [(tuple(weakref.ref(t) for t in tensors), versions, ops)]
    return ops


_prepared_last: list = []  # [(weakrefs of w1, b1, w2, b2), their versions, operands]


def _prepared(w1, b1, w2, b2):
    """The kernel's weight operands: ``conv_weight_tiles(w1)`` and the fp32
    ``[b1, w2, b2]`` of bf16 values, built once for the same tensors."""
    def build():
        epi = torch.cat([b1.reshape(-1), w2.reshape(-1), b2.reshape(-1)]).to(torch.bfloat16)
        return conv_weight_tiles(w1.detach()), epi.float().detach()

    return cached_operands(_prepared_last, (w1, b1, w2, b2), build)


def _launch_args(x, w1, b1, w2, b2, out_h: int, out_w: int):
    n, h, w, c = x.shape
    if x.dtype != torch.bfloat16:
        raise TypeError(f"output_tail kernel takes bf16, got {x.dtype}")
    if (tuple(w1.shape) != (_MID, c, 3, 3) or b1.numel() != _MID or w2.numel() != _MID
            or b2.numel() != 1):
        raise ValueError("output_tail takes w1 (32, C, 3, 3), b1 (32,), w2 (1, 32, 1, 1), b2 (1,)")
    if any(t.device != x.device for t in (w1, b1, w2, b2)):
        raise ValueError("output_tail operands must share x's device")
    if not kernel_takes(x.shape, x.dtype, out_h, out_w):
        raise NotImplementedError(
            f"output_tail kernel takes C in {_SUPPORTED_C} and the taps of one "
            f"{_TILE[0]}x{_TILE[1]} tile within {_PATCH[0]}x{_PATCH[1]} source pixels; got C={c}, "
            f"{h}x{w} -> {out_h}x{out_w}")
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("output_tail needs a 16-byte aligned input")
    wf, epi = _prepared(w1, b1, w2, b2)
    ytab = _tile_taps(h, out_h, _TILE[0], x.device)
    xtab = _tile_taps(w, out_w, _TILE[1], x.device)
    out = torch.empty((n, out_h, out_w, 1), dtype=x.dtype, device=x.device)
    keep = (x, wf, epi)  # alive until the launch is enqueued
    return out, keep, (*(cuda_build.ptr(t) for t in (x, ytab, xtab, wf, epi, out)),
                       n, h, w, c, out_h, out_w, cuda_build.stream_of(x))


def output_tail(x, w1, b1, w2, b2, out_h: int, out_w: int) -> torch.Tensor:
    """``(N, H, W, C)`` → ``(N, out_h, out_w, 1)`` depth.  CPU tensors take
    the plain version; CUDA tensors launch the tail kernel or raise."""
    cuda_build.no_history("output_tail", x, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return output_tail_plain(x, w1, b1, w2, b2, out_h, out_w)
    out, _keep, args = _launch_args(x, w1, b1, w2, b2, out_h, out_w)
    cuda_build.check(_kernel()(*args), "output_tail")
    output_tail.launches += 1
    c = x.shape[-1]
    output_tail.width_launches[c] = output_tail.width_launches.get(c, 0) + 1
    return out


SPLIT_STAGES = ("resize", "conv", "epilogue")


def output_tail_split(x, w1, b1, w2, b2, out_h: int, out_w: int, iters: int = 20) -> dict:
    """The tail kernel's time by stage: CUDA events around ``iters``
    launches of instantiations that stop after the resize and after the
    conv GEMM, and of the whole kernel; each stage's mean ms is the
    difference of successive stops, plus ``whole``.  Not counted as
    launches."""
    _, _keep, args = _launch_args(x.contiguous(), w1, b1, w2, b2, out_h, out_w)
    ms = (ctypes.c_float * 3)()
    cuda_build.check(_kernel("output_tail_split")(*args, iters, ms), "output_tail_split")
    out = {name: ms[k] - (ms[k - 1] if k else 0.0) for k, name in enumerate(SPLIT_STAGES)}
    out["whole"] = ms[2]
    return out


output_tail.launches = 0
output_tail.width_launches = {}  # launches by width C


class OutputTailFn(torch.autograd.Function):
    """Differentiable tail: ``apply(x, w1, b1, w2, b2, out_h, out_w)``."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, out_h, out_w):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        ctx.out_hw = (out_h, out_w)
        return output_tail(x, w1, b1, w2, b2, out_h, out_w)

    @staticmethod
    def backward(ctx, g):
        def plain(*args):
            return output_tail_plain(*args, *ctx.out_hw)

        grads = recompute_vjp(plain, ctx.saved_tensors, ctx.needs_input_grad[:5], g)
        return (*grads, None, None)
