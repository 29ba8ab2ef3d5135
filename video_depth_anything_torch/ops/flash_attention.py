"""Kernel A: spatial flash attention (``csrc/flash_attention.cu``, on fp32
operands ``csrc/flash_attention_f32.cu``, at D ≥ 320
``csrc/flash_attention_wide.cu``) and its backward
(``csrc/flash_attention_bwd.cu``).

Replaces ``video_depth_anything_tpu/ops/pallas_attention.py``
``_flash_kernel_native`` (``flash_attention_native``), ``_flash_kernel``
and ``_flash_kernel_fast`` (``_flash_forward`` via
``spatial_flash_attention``) and ``_flash_kernel_single`` (odd head counts
and D ≠ 64); the backward kernel replaces ``_flash_kernel_native_bwd``
(``_native_bwd_pallas``).  ``flash_gate`` is the JAX dispatch rule of
``try_spatial_attention``: head_dim a multiple of 64 but not of 128, and
at least 256 tokens.  The forward kernels take that gate's whole domain
(``kernel_takes``), any head count, exact or ``fast`` (the ``:fast`` impl
suffix's no-max softmax): D = 64 (every shipped encoder) and D = 192 on
the Hopper kernels, every D ≡ 64 (mod 128) from 320 on the wide kernel
(``wide``: ``wgmma`` fed by a TMA ring, 64-query CTAs whose consumer
warpgroup keeps one 320-column slice of O, S summed over the panels of D
once a slice; in fp32 after a pre-pass that splits q, k and vᵀ into hi
and lo).  ``bwd_gate`` is where the JAX package runs
the Pallas backward (the native layout: D = 64, H even, at most 2048
padded keys); elsewhere its VJP is the dense einsum backward, and so is
the port's.

``FlashAttentionFn`` is the differentiable entry: its forward launches
Kernel A (saving the per-row log-sum-exp where ``bwd_gate`` holds), its
backward the backward kernel; on CPU tensors both are the plain
versions.  ``flash_attention`` and ``flash_attention_bwd`` are the raw
launches and keep no autograd history.  ``flash_attention.launches``
counts the exact variant's launches and ``flash_attention.fast_launches``
the fast variant's, both bf16 at D = 64 and 192;
``flash_attention.f32_launches`` counts the fp32 kernel's (either
variant); ``wide_launches`` and ``wide_f32_launches`` the wide kernel's
(bf16 and fp32, either variant).  The fp32 kernels are the JAX kernels on
fp32 inputs (their gates check no dtype; p stays fp32): both products in
3xTF32 on the tensor cores (every operand split into hi = rna(x) and
lo = rna(x − hi), three TF32 products summed in fp32: fp32-accurate), same
domain, forward only (no JAX entry point trains in fp32), no
log-sum-exp.  The wide kernel writes no log-sum-exp either: no backward
kernel reads one at D ≠ 64.

Bound on the H100: tensor-core FLOPs (4·N²·D·H·B forward, 10·N²·D·H·B
backward); the fp32 kernels', three times the forward's FLOPs at the
tensor cores' TF32 rate; the wide kernel computes S once a 320-column
slice (``wide_flops``: the dense work at D = 320); see the source notes.
"""

from __future__ import annotations

import ctypes

import torch

from video_depth_anything_torch.ops import cuda_build

LOG2E = 1.4426950408889634
HEAD_DIMS = (64, 192)  # the Hopper forward kernels' instantiations
WIDE_PANEL = 64  # a 64-column panel of O (and, in bf16, of an S-step's Q and K)
WIDE_SLICE = 320  # output columns a consumer of the wide kernel keeps (five panels)


def flash_gate(shape) -> bool:
    """True where the JAX package sends ``(B, N, H, D)`` to a flash kernel."""
    if len(shape) != 4:
        return False
    _, n, _, d = shape
    return d % 64 == 0 and d % 128 != 0 and n >= 256


def wide(d: int) -> bool:
    """Whether head width ``d`` takes the wide kernel
    (``csrc/flash_attention_wide.cu``): D ≡ 64 (mod 128), D ≥ 320."""
    return d % 128 == 64 and d >= 320


def kernel_takes(shape, dtype) -> bool:
    """Whether Kernel A's forward takes ``(B, N, H, D)`` q, k and v of
    ``dtype``: bf16 or fp32, any B, N and H, D = 64 or 192 (the Hopper
    kernels) or ``wide``.  Every shape ``flash_gate`` admits.  Pure: no
    card needed."""
    if len(shape) != 4 or dtype not in (torch.bfloat16, torch.float32):
        return False
    d = shape[3]
    return d in HEAD_DIMS or wide(d)


def wide_flops(b: int, n: int, h: int, d: int) -> float:
    """FLOPs of the wide kernel's plan: for each 320-column slice of O
    (the last one starts at D − 320, overlapping the one before), S = Q·Kᵀ
    over all D and P·V over the slice's 320 columns,
    (2·N²·D + 2·N²·320)·⌈D / 320⌉ a (b, h): the dense 4·N²·D at D = 320."""
    slices = -(-d // WIDE_SLICE)
    return 2.0 * n * n * (d + WIDE_SLICE) * slices * b * h


def wide_f32_scratch_elems(b: int, n: int, h: int, d: int) -> int:
    """fp32 elements of the wide fp32 kernel's scratch: its pre-pass's hi
    and lo copies of q·scale·log2 e and k, (B, N, H, D) each, and of vᵀ,
    (B, D, H, Np) with N padded to 32 keys."""
    return 4 * b * n * h * d + 2 * b * d * h * (-(-n // 32) * 32)


def bwd_gate(shape) -> bool:
    """True where the JAX package's VJP is the Pallas backward kernel
    (``flash_attention_native``, ``pallas_attention.py:676-687``)."""
    _, n, h, d = shape
    return flash_gate(shape) and d == 64 and h % 2 == 0 and -(-n // 128) * 128 <= 2048


def flash_attention_plain(q, k, v, scale: float, fast: bool = False) -> torch.Tensor:
    """Dense attention over ``(B, N, H, D)``: fp32 scores and softmax,
    probabilities cast to the input dtype, fp32 accumulate, output in the
    input dtype (``ops/attention.py:_xla_attention`` in the JAX package).
    ``fast`` is the no-max softmax of the ``:fast`` kernels,
    p = exp2(s·log2 e) / Σ in fp32: the same quotient while the scaled
    logits stay inside fp32's exp2 domain (about ±88)."""
    dtype = q.dtype
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if fast:
        e = torch.exp2(s * LOG2E)
        p = (e / e.sum(dim=-1, keepdim=True)).to(dtype)
    else:
        p = torch.softmax(s, dim=-1).to(dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())
    return out.to(dtype)


def flash_attention_bwd_plain(q, k, v, o, g, scale: float):
    """``(dq, dk, dv)`` of ``flash_attention_plain`` at the output ``o``
    for the cotangent ``g``: the dense fp32 math of the JAX einsum backward
    (``pallas_attention.py:425-439``) with the backward kernel's rounding
    points (the TPU kernel's): p normalised in fp32 and rounded to the
    input dtype before pᵀg, ds rounded before both products, dq and dk
    scaled in fp32 after them.  Δ = rowsum(g⊙o) as in the kernel, which
    is rowsum(dp⊙p) up to the rounding of o.  q and g may have fewer rows
    than k and v (``chip_smoke.py`` drops a query tile that way)."""
    dt = q.dtype
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale, dim=-1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    delta = (gf * o.float()).sum(-1).permute(0, 2, 1)[..., None]
    ds = (p * (dp - delta)).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq.to(dt), dk.to(dt), dv.to(dt)


_fns = {}


def _kernel(name: str):
    if name not in _fns:
        ll, vp, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
        if name == "fwd":
            fn = cuda_build.library("flash_attention").vda_flash_attention_fwd
            fn.argtypes = [vp] * 4 + [i] * 4 + [ll] * 12 + [ctypes.c_float, i, vp, vp]
        elif name == "f32":
            fn = cuda_build.library("flash_attention_f32").vda_flash_attention_f32
            fn.argtypes = [vp] * 4 + [i] * 4 + [ll] * 12 + [ctypes.c_float, i, vp]
        elif name in ("wide", "wide_f32"):
            fn = getattr(cuda_build.library("flash_attention_wide"), f"vda_flash_attention_{name}")
            # ..., scale, fast, then bf16's q_resident (-1: where it fits) or
            # fp32's scratch, then the stream
            fn.argtypes = ([vp] * 4 + [i] * 4 + [ll] * 12 + [ctypes.c_float, i]
                           + ([vp] if name == "wide_f32" else [i]) + [vp])
        else:
            fn = getattr(cuda_build.library("flash_attention_bwd"), f"vda_flash_attention_{name}")
            fn.argtypes = [vp] * 10 + [i] * 3 + [ll] * 9 + [ctypes.c_float, vp]
            if name == "bwd_split":
                fn.argtypes += [i, ctypes.POINTER(ctypes.c_float)]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def tma_geometry(t) -> tuple:
    """``(dims, byte_strides)`` of a ``(B, N, H, D)`` view as the kernels'
    TMA maps describe it (2-byte elements in bf16, 4-byte in fp32): dims
    innermost first ``(D, H, N, B)``,
    the byte strides of H, N and B (a dimension of size 1 takes the dense
    stride, its own being never used).  Raises ``ValueError`` on what a
    tensor map cannot describe: D not unit-stride, a base not 16-byte
    aligned, a stride not a multiple of 16 bytes."""
    if t.dim() != 4:
        raise ValueError(f"expected a (B, N, H, D) view, got shape {tuple(t.shape)}")
    b, n, h, d = t.shape
    sb, sn, sh, sd = t.stride()
    item = t.element_size()
    if sd != 1 and d > 1:
        raise ValueError(f"TMA needs unit stride in D, got stride {sd}")
    if t.data_ptr() % 16:
        raise ValueError(f"TMA needs a 16-byte aligned base, got address {t.data_ptr():#x}")
    strides, dense = [], d * item
    for size, stride in ((h, sh), (n, sn), (b, sb)):
        nbytes = stride * item if size > 1 else dense
        if nbytes % 16:
            raise ValueError(f"TMA needs strides that are multiples of 16 bytes, got "
                             f"{nbytes} bytes in shape {tuple(t.shape)}")
        strides.append(nbytes)
        dense = nbytes * size
    return (d, h, n, b), tuple(strides)


def _check_inputs(what: str, *tensors, takes=lambda d: d == 64,
                  dtypes=(torch.bfloat16,)) -> list:
    """Raise on what the kernels do not take (``takes``: whether they take
    head width D); return each tensor's ``(B, N, H)`` element strides from
    ``tma_geometry``, flat."""
    shape, device, dtype = tensors[0].shape, tensors[0].device, tensors[0].dtype
    if not takes(shape[3]):
        raise NotImplementedError(f"{what} kernel does not take head_dim {shape[3]}")
    strides = []
    for t in tensors:
        if t.dtype not in dtypes or t.dtype != dtype:
            raise TypeError(f"{what} kernel takes one of {dtypes}, got {[t.dtype for t in tensors]}")
        if t.shape != shape or t.device != device:
            raise ValueError(f"{what}: operands must share shape and device")
        sh, sn, sb = tma_geometry(t)[1]
        item = t.element_size()
        strides += (sb // item, sn // item, sh // item)
    return strides


def flash_attention(q, k, v, scale: float, with_lse: bool = False, fast: bool = False):
    """Attention over ``(B, N, H, D)`` tensors, which may be strided views
    of a fused qkv projection; D = 64, 192 or ``wide``, any head count,
    bf16 or fp32 (``kernel_takes``).  CPU tensors take the plain version;
    CUDA tensors launch Kernel A (its fp32 kernel on fp32 operands, the
    wide kernel at D ≥ 320) or raise.  ``with_lse`` (CUDA, bf16, D = 64 or
    192) also returns the fp32 ``(B, H, N)`` log-sum-exp of the scaled
    scores in the exp2 domain, which ``flash_attention_bwd`` takes.

    ``fast`` launches the no-max variant (the JAX ``:fast`` suffix): no
    running max and no rescale.  Its result is the exact softmax's while
    every scaled logit q·k·scale stays inside fp32's exp2 domain (about
    ±88); beyond it the card's exp2 overflows to inf and the output turns
    to nan, where the TPU's polynomial exp2 clamps.  Nothing checks or
    switches variants."""
    cuda_build.no_history("flash_attention", q, k, v)
    if q.device.type == "cpu":
        if with_lse:
            raise ValueError("the log-sum-exp comes from the CUDA kernel only")
        return flash_attention_plain(q, k, v, scale, fast=fast)
    strides = _check_inputs("flash_attention", q, k, v, takes=lambda d: d in HEAD_DIMS or wide(d),
                            dtypes=(torch.bfloat16, torch.float32))
    b, n, h, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    if wide(d):
        if with_lse:
            raise ValueError("the wide kernel writes no log-sum-exp: the backward kernel "
                             "takes D = 64 only")
        f32 = q.dtype == torch.float32
        # the fp32 pre-pass's hi and lo copies (stream-ordered: freed after the launch)
        scratch = torch.empty(wide_f32_scratch_elems(b, n, h, d), dtype=torch.float32,
                              device=q.device) if f32 else None
        err = _kernel("wide_f32" if f32 else "wide")(
            cuda_build.ptr(q), cuda_build.ptr(k), cuda_build.ptr(v), cuda_build.ptr(out),
            b, n, h, d, *strides, n * h * d, h * d, d, float(scale), int(fast),
            cuda_build.ptr(scratch) if f32 else -1, cuda_build.stream_of(q))
        cuda_build.check(err, "flash_attention (wide)")
        if f32:
            flash_attention.wide_f32_launches += 1
        else:
            flash_attention.wide_launches += 1
        return out
    if q.dtype == torch.float32:
        if with_lse:
            raise ValueError("the fp32 kernel writes no log-sum-exp: no JAX entry point "
                             "trains in fp32")
        err = _kernel("f32")(
            cuda_build.ptr(q), cuda_build.ptr(k), cuda_build.ptr(v), cuda_build.ptr(out),
            b, n, h, d, *strides, n * h * d, h * d, d, float(scale), int(fast),
            cuda_build.stream_of(q))
        cuda_build.check(err, "flash_attention (fp32)")
        flash_attention.f32_launches += 1
        return out
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device) if with_lse else None
    err = _kernel("fwd")(
        cuda_build.ptr(q), cuda_build.ptr(k), cuda_build.ptr(v), cuda_build.ptr(out),
        b, n, h, d, *strides, n * h * d, h * d, d,
        float(scale), int(fast), None if lse is None else cuda_build.ptr(lse),
        cuda_build.stream_of(q),
    )
    cuda_build.check(err, "flash_attention")
    if fast:
        flash_attention.fast_launches += 1
    else:
        flash_attention.launches += 1
    return (out, lse) if with_lse else out


flash_attention.launches = 0
flash_attention.fast_launches = 0
flash_attention.f32_launches = 0
flash_attention.wide_launches = 0  # bf16 at D >= 320, either variant
flash_attention.wide_f32_launches = 0  # and fp32


def _bwd_args(q, k, v, o, lse, g, scale: float):
    """The backward's C arguments, after its input checks, and the
    ``(dq, dk, dv)`` they write."""
    cuda_build.no_history("flash_attention_bwd", q, k, v, o, g)
    if q.device.type != "cuda":
        raise ValueError("flash_attention_bwd is the CUDA kernel; the CPU takes "
                         "flash_attention_bwd_plain")
    o, g = o.contiguous(), g.contiguous()
    strides = _check_inputs("flash_attention_bwd", q, k, v, o, g)[:9]
    b, n, h, d = q.shape
    if lse is None or lse.shape != (b, h, n) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("flash_attention_bwd takes Kernel A's fp32 (B, H, N) log-sum-exp")
    # the pre-pass's padded lse and Δ (csrc/flash_attention_bwd.cu)
    aux = torch.empty((2, b * h, -(-n // 128) * 128), dtype=torch.float32, device=q.device)
    # one allocation for dq, dk and dv
    grads = torch.empty((3, b, n, h, d), dtype=q.dtype, device=q.device).unbind(0)
    args = (*(cuda_build.ptr(t) for t in (q, k, v, o, g, lse, aux, *grads)),
            b, n, h, *strides, float(scale), cuda_build.stream_of(q))
    return args, grads


def flash_attention_bwd(q, k, v, o, lse, g, scale: float):
    """``(dq, dk, dv)`` from the backward kernel, given Kernel A's output
    ``o`` and ``lse`` (``flash_attention(..., with_lse=True)``) and the
    cotangent ``g``; CUDA tensors only.  q, k, v may be strided views;
    the gradients come back contiguous ``(B, N, H, D)``."""
    args, grads = _bwd_args(q, k, v, o, lse, g, scale)
    cuda_build.check(_kernel("bwd")(*args), "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return grads


flash_attention_bwd.launches = 0
BWD_LAUNCHES = ("delta", "dkdv", "dq")


def flash_attention_bwd_split(q, k, v, o, lse, g, scale: float, iters: int = 20) -> dict:
    """Mean ms of each of the backward's three launches (the pre-pass
    that forms Δ, the dK/dV kernel, the dQ kernel) over ``iters``
    backwards after as many untimed ones, from CUDA events around each
    launch; not counted as launches."""
    args, _ = _bwd_args(q, k, v, o, lse, g, scale)
    ms = (ctypes.c_float * 3)()
    for _ in range(2):
        cuda_build.check(_kernel("bwd_split")(*args, iters, ms), "flash_attention_bwd")
    return dict(zip(BWD_LAUNCHES, ms))


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable Kernel A: ``apply(q, k, v, scale, fast)`` on
    ``(B, N, H, D)``.  On the card the forward launches Kernel A (the fast
    variant where ``fast``) and, where ``bwd_gate`` holds, keeps its
    log-sum-exp; the backward launches the backward kernel there and runs
    ``flash_attention_bwd_plain`` elsewhere (as the JAX package's blocked
    path does).  The fast forward's log-sum-exp is log2 of its row sum, so
    the backward kernel recomputes the same normalised P from it, as the
    TPU's fast backward does.  On the CPU both directions are the plain
    versions; in fp32 the forward is the fp32 kernel and the backward the
    plain version (the backward kernel is bf16: no JAX entry point trains
    in fp32)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, fast=False):
        if q.device.type == "cpu":
            out, lse = flash_attention_plain(q, k, v, scale, fast=fast), None
        elif q.dtype == torch.bfloat16 and bwd_gate(q.shape):
            out, lse = flash_attention(q, k, v, scale, with_lse=True, fast=fast)
        else:
            out, lse = flash_attention(q, k, v, scale, fast=fast), None
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        if lse is not None:  # kept where bwd_gate holds
            dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, g, ctx.scale)
        else:
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, o, g, ctx.scale)
        return dq, dk, dv, None, None
