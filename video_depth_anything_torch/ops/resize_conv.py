"""Fused bilinear resize → conv3×3 + bias (``csrc/resize_conv.cu``).

Replaces ``video_depth_anything_tpu/ops/pallas_resize_conv.py``
``_resize_conv_kernel`` (``fused_resize_conv``): on ``(N, H, W, C)`` it
computes bilinear align_corners resize to ``(out_h, out_w)`` → conv3×3
C→128 (padding 1) + bias, and writes only the ``(N, out_h, out_w, 128)``
result.  As in the JAX package, no model path calls it: it is a
standalone differentiable op, kept beside the plain chain that the model
runs (the TPU kernel lost to XLA at the vitl refinenet1 → ``output_conv1``
junction, the file's docstring says).

``resize_conv_plain`` is the port of ``xla_resize_conv``
(``pallas_resize_conv.py:168-176``): ``ops/resize.bilinear_resize``
(align_corners, fp32 arithmetic, one rounding to x's dtype), then
``F.conv2d`` at padding 1 (fp32 sums, one rounding), then the bias added
in x's dtype.
``resize_conv_gate`` is the rule of ``try_fused_resize_conv``
(``:300-323``): bf16, 4-d, h, w ≥ 2, C a multiple of 128, w of 3×3×C,
Cout = 128, and the TPU kernel's row-block plan within its 97 MiB VMEM
budget (``_row_block``, ``:184-214``).

Weights use the port's (the reference torch) layout: ``w (128, C, 3, 3)``,
``b (128,)``.  ``ResizeConvFn`` is the differentiable entry: the kernel
forward (the plain chain on CPU tensors) and the plain chain's gradient
backward, as the JAX VJP (``:287-297``).  ``resize_conv`` is the raw launch
and keeps no autograd history.

The kernel (``resize_conv_hopper``) walks 16×16-pixel output tiles in
persistent CTAs: one warpgroup builds the resized tile, four run the conv
on ``wgmma`` with the weights streaming through a TMA ring of (chunk, tap)
B tiles (``weight_tiles``, built on the device once for the same weight
tensors), and the tap tables come from a per-(size, device) cache
(``output_tail._tile_taps``), so a call makes no host-to-device copy.  Where a tile's taps spread over more than
12×12 source pixels (downsampling, near-identity sizes) the builders read
them from global memory in place of a staged source patch: every shape
the gate admits runs.

Bound on the H100: tensor-core FLOPs (589,824 per output pixel at
C = 256); see the source.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from video_depth_anything_torch.ops import cuda_build
from video_depth_anything_torch.ops.dispatch import recompute_vjp
from video_depth_anything_torch.ops.motion_module import sw128_tiles
from video_depth_anything_torch.ops.output_tail import (
    _CHUNK,
    _VMEM_BUDGET,
    _patch_span,
    _pick_row_block,
    _round_up,
    _row_span,
    _tile_taps,
    cached_operands,
)
from video_depth_anything_torch.ops.resize import bilinear_resize

COUT = 128  # the only output width of the TPU kernel and of the gate


def _row_block(out_h: int, out_w: int, in_h: int, w: int, c: int, cout: int):
    """The TPU kernel's row-block plan ``(r_blk, r_sub, u4, rg)``, or None
    where no row block fits its VMEM budget (``pallas_resize_conv.py:184-214``)."""
    for top in (104, 72, 48, 40, 32):
        r_blk = _pick_row_block(out_h, top)
        r_sub = r_blk if r_blk <= 24 else -(-r_blk // 4)
        span = _row_span(in_h, out_h, r_blk)
        rg = max(1, 512 // c) if span >= max(1, 512 // c) else 1
        u4 = _round_up(span, rg)
        ws = _round_up(out_w + 2, 8)
        w2 = _round_up(max(ws + 8, 1 + max(out_w, _CHUNK)), 8)
        w8 = _round_up(w, 8)
        est = (u4 * w8 * c * 2 + rg * w8 * c * 2 + u4 * w2 * c * 4
               + (r_blk + 2) * w2 * c * 2 + 2 * (r_blk + 2) * ws * c * 2
               + r_sub * ws * (c * 2 + max(cout, 128) * 4) * 3)
        if u4 > in_h:  # the row-group rounding asks for more input rows than exist
            continue
        if est <= _VMEM_BUDGET:
            return r_blk, r_sub, u4, rg
    return None


def resize_conv_gate(shape, dtype, w_shape, out_h: int, out_w: int) -> bool:
    """True where the JAX package's ``try_fused_resize_conv`` runs its
    Pallas kernel on x of ``shape (N, H, W, C)`` and weights of ``w_shape
    (Cout, C, 3, 3)``."""
    if len(shape) != 4 or dtype != torch.bfloat16:
        return False
    _, h, w, c = shape
    if h < 2 or w < 2 or c % 128 or tuple(w_shape[1:]) != (c, 3, 3) or w_shape[0] != COUT:
        return False
    return _row_block(out_h, out_w, h, w, c, COUT) is not None


def resize_conv_plain(x, w, b, out_h: int, out_w: int) -> torch.Tensor:
    """``(N, H, W, C)`` → ``(N, out_h, out_w, Cout)`` in x's dtype:
    resize, conv3×3 with no bias, then the bias added in x's dtype.  The
    conv takes the resized map and the weights rounded to x's dtype and
    sums in fp32, then rounds once (XLA's bf16 conv; cuDNN's bf16 3×3
    algorithms on the card round more coarsely).  TF32, where cuDNN
    enables it, holds bf16 values exactly."""
    dt = x.dtype
    y = bilinear_resize(x, out_h, out_w).permute(0, 3, 1, 2)
    y = F.conv2d(y.float(), w.to(dt).float(), padding=1).to(dt).permute(0, 2, 3, 1)
    return y + b.to(dt)


# csrc/resize_conv.cu's output tile (16 x 16 pixels), the source patch its
# builders stage (12 x 12 pixels) and the channels of a B tile's K.
TILE = 16
PATCH = 12
CHUNK = 64
_vp, _i = ctypes.c_void_p, ctypes.c_int
# vda_resize_conv: x, ytab, xtab, w tiles, bias, out, N, H, W, C, out_h,
# out_w, patch, stream
ARGTYPES = [_vp] * 6 + [_i] * 7 + [_vp]
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = cuda_build.library("resize_conv").vda_resize_conv
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def weight_tiles(w: torch.Tensor) -> torch.Tensor:
    """``w (128, C, 3, 3)`` → the kernel's wgmma B tiles, bf16 ``(9·C/64,
    128, 64)``: tile ``9·cc + tap`` holds W[tap, 64·cc + k, n] (tap = 3·dy +
    dx) at row n (the output channel), K-major and 128-byte swizzled
    (``sw128_tiles``), so a bulk copy of a tile is a wgmma operand as it
    is.  Torch ops on w's device."""
    c = w.shape[1]
    w_kn = w.permute(2, 3, 1, 0).reshape(9, c // CHUNK, CHUNK, COUT).transpose(0, 1)
    return sw128_tiles(w_kn.reshape(9 * c, COUT), rows=COUT)


_prepared_last: list = []  # [(weakrefs of w, b), their versions, operands]


def _prepared(w, b):
    """The kernel's weight operands, ``weight_tiles(w)`` and the fp32 bias of
    bf16 values, built once for the same tensors (``cached_operands``)."""
    return cached_operands(_prepared_last, (w, b), lambda: (
        weight_tiles(w.detach()), b.detach().reshape(-1).to(torch.bfloat16).float()))


def _launch_args(x, w, b, out_h: int, out_w: int):
    """``(out, keep, args)`` of a launch on CUDA tensors: the output, the
    tensors the arguments point into, and ``vda_resize_conv``'s arguments.
    Raises on what the kernel does not take."""
    n, h, wd, c = x.shape
    if x.dtype != torch.bfloat16:
        raise TypeError(f"resize_conv kernel takes bf16, got {x.dtype}")
    if c % 128:
        raise NotImplementedError(f"resize_conv kernel takes C a multiple of 128, got {c}")
    if tuple(w.shape) != (COUT, c, 3, 3) or b.numel() != COUT:
        raise ValueError("resize_conv takes w (128, C, 3, 3) and b (128,)")
    if any(t.device != x.device for t in (w, b)):
        raise ValueError("resize_conv operands must share x's device")
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("resize_conv needs a 16-byte aligned input")
    wt, bias = _prepared(w, b)
    ytab = _tile_taps(h, out_h, TILE, x.device)
    xtab = _tile_taps(wd, out_w, TILE, x.device)
    patch = _patch_span(h, out_h, TILE) <= PATCH and _patch_span(wd, out_w, TILE) <= PATCH
    out = torch.empty((n, out_h, out_w, COUT), dtype=x.dtype, device=x.device)
    keep = (x, ytab, xtab, wt, bias)  # alive until the launch is enqueued
    return out, keep, (*(cuda_build.ptr(t) for t in (*keep, out)), n, h, wd, c, out_h, out_w,
                       int(patch), cuda_build.stream_of(x))


def resize_conv(x, w, b, out_h: int, out_w: int) -> torch.Tensor:
    """``(N, H, W, C)`` → ``(N, out_h, out_w, 128)``.  CPU tensors take the
    plain version; CUDA tensors launch the kernel (bf16, C a multiple of
    128, Cout = 128) or raise."""
    cuda_build.no_history("resize_conv", x, w, b)
    if x.device.type == "cpu":
        return resize_conv_plain(x, w, b, out_h, out_w)
    out, _keep, args = _launch_args(x, w, b, out_h, out_w)
    cuda_build.check(_kernel()(*args), "resize_conv")
    resize_conv.launches += 1
    return out


resize_conv.launches = 0


class ResizeConvFn(torch.autograd.Function):
    """Differentiable resize → conv: ``apply(x, w, b, out_h, out_w)``."""

    @staticmethod
    def forward(ctx, x, w, b, out_h, out_w):
        ctx.save_for_backward(x, w, b)
        ctx.out_hw = (out_h, out_w)
        return resize_conv(x, w, b, out_h, out_w)

    @staticmethod
    def backward(ctx, g):
        def plain(*args):
            return resize_conv_plain(*args, *ctx.out_hw)

        grads = recompute_vjp(plain, ctx.saved_tensors, ctx.needs_input_grad[:3], g)
        return (*grads, None, None)
