"""Kernel A: spatial flash attention (``csrc/flash_attention.cu``).

Replaces ``video_depth_anything_tpu/ops/pallas_attention.py``
``_flash_kernel_native`` (``flash_attention_native``) and ``_flash_kernel``
(``_flash_forward`` via ``spatial_flash_attention``).  ``flash_gate`` is
the JAX dispatch rule of ``try_spatial_attention``: head_dim a multiple of
64 but not of 128, and at least 256 tokens.  The kernel takes D = 64, the
head width of every shipped encoder.

Bound on the H100: tensor-core FLOPs (4·N²·D·H·B); see the source note.
"""

from __future__ import annotations

import ctypes

import torch

from video_depth_anything_torch.ops import cuda_build


def flash_gate(shape) -> bool:
    """True where the JAX package sends ``(B, N, H, D)`` to a flash kernel."""
    if len(shape) != 4:
        return False
    _, n, _, d = shape
    return d % 64 == 0 and d % 128 != 0 and n >= 256


def flash_attention_plain(q, k, v, scale: float) -> torch.Tensor:
    """Dense attention over ``(B, N, H, D)``: fp32 scores and softmax,
    probabilities cast to the input dtype, fp32 accumulate, output in the
    input dtype (``ops/attention.py:_xla_attention`` in the JAX package)."""
    dtype = q.dtype
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1).to(dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())
    return out.to(dtype)


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = cuda_build.library("flash_attention").vda_flash_attention_fwd
        ll, vp = ctypes.c_longlong, ctypes.c_void_p
        fn.argtypes = [vp, vp, vp, vp, ctypes.c_int, ctypes.c_int, ctypes.c_int] + [ll] * 12 + [
            ctypes.c_float, vp]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def flash_attention(q, k, v, scale: float) -> torch.Tensor:
    """Attention over ``(B, N, H, D)`` tensors, which may be strided views
    of a fused qkv projection.  CPU tensors take the plain version; CUDA
    tensors launch Kernel A or raise."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    b, n, h, d = q.shape
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes bf16, got {q.dtype}")
    if d != 64:
        raise NotImplementedError(f"flash_attention kernel takes head_dim 64, got {d}")
    for t in (q, k, v):
        if t.shape != q.shape or t.device != q.device:
            raise ValueError("q, k and v must share shape and device")
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError("flash_attention needs 16-byte aligned rows with unit stride in D")
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    err = _kernel()(
        cuda_build.ptr(q), cuda_build.ptr(k), cuda_build.ptr(v), cuda_build.ptr(out),
        b, n, h,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        float(scale), cuda_build.stream_of(q),
    )
    cuda_build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
