"""Kernel A's probe kernels (``csrc/attention_variants_hopper.cu``).

Replaces the TPU kernels of the two probe scripts that split Kernel A's
time on the TPU:

* ``scripts/bench_spatial_variants.py`` ``_kernel_ilv`` (variants ``ilv``,
  ``nomask``), ``_kernel_chunk`` (``chunk<k>``) and ``_kernel_sbf16``
  (``sbf16``, ``sbf16:fast``, ``ceiling``), launched by ``run_variant``:
  spatial attention on the head-interleaved ``(B, N, H·D)`` layout with
  the polynomial exp2 and no row max (``ilv``, ``nomask``, ``chunk``,
  ``sbf16:fast``), a bf16 score tile (``sbf16``, exact over the global row
  max) or no softmax at all (``ceiling``: the GEMM floor);
* ``scripts/bench_softmax_chain.py`` ``make_kernel``'s ``kern``: QKᵀ → one
  of seven elementwise chains → P·V[:, :d], unnormalised, on ``(BH, N, D)``.

All are Hopper kernels: ``wgmma`` fed by TMA rings.  ``ilv`` /
``nomask``, ``chunk<k>`` and ``sbf16`` / ``sbf16:fast`` / ``ceiling`` take
the TPU kernels' stagger and software pipeline on asynchronous products
(exact ``sbf16`` in two passes over the keys, the first for the global row
max); the chain kernel is Kernel A's skeleton (``bf16x`` in two passes).
They read their
operands through 4-D tensor maps ``(D, H, N, B)`` (the chain's V as the
``(BH, Nk, 1, 64)`` view of its first 64 columns), so the launch checks
each with ``flash_attention.tma_geometry`` and raises on what a map
cannot describe.

``spatial_variant_plain`` and ``softmax_chain_plain`` define the numerics
(the scripts' rounding points: q prescaled by scale·log2 e in fp32 and
rounded to bf16, q padded to a multiple of 16 rows and k, v to 128, fp32
scores, P rounded to bf16 before P·V).  ``exp2_poly`` is the TPU package's
``_exp2_poly`` (``ops/pallas_attention.py:54-74``); ``schraudolph_exp2``
and ``cubic_exp2`` are the bit-trick exponentials of
``bench_softmax_chain.py:68-80``.  The kernels compute those on the FMA
units, not with the hardware exp2: that is the question the probes ask.

``spatial_variant`` and ``softmax_chain`` are the launches: CPU tensors
take the plain version, CUDA tensors launch the kernel or raise.  Each
kernel counts its launches on its own wrapper (``ilv_attention``,
``chunk_attention``, ``sbf16_attention``, ``softmax_chain``).  A variant
outside the scripts' domain raises ``ValueError`` before any launch, as
``run_variant`` raises or asserts (``chunk8`` at n = 1370: 1376 / 8 = 172
rows, not a multiple of 8).

Bound on the H100: tensor-core FLOPs, and for the polynomial chains the
chain's instruction issue; see the sources.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from video_depth_anything_torch.ops import cuda_build
from video_depth_anything_torch.ops.flash_attention import tma_geometry

LOG2E = 1.4426950408889634
# the probe scripts' default lists (bench_spatial_variants.py:280-283,
# bench_softmax_chain.py:118)
SPATIAL_VARIANTS = ("ilv", "nomask", "chunk2", "chunk4", "chunk8", "sbf16", "sbf16:fast",
                    "ceiling")
CHAIN_MODES = ("gemms", "exp", "exact", "sexp", "pexp", "bf16s", "bf16x")
# Degree-4 fit of 2^f on [0, 1) (pallas_attention.py:54)
EXP2_C = (1.00000526, 0.69297426, 0.241508857, 0.051989575, 0.0135115307)
_NEG = -1e30


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def exp2_poly(x: torch.Tensor) -> torch.Tensor:
    """2^x for fp32 ``x``: the exponent assembled in the int32 exponent
    field (x clamped to −200, the biased exponent to [0, 254]) times a
    degree-4 polynomial of the fraction."""
    x = torch.clamp(x, min=-200.0)
    xi = torch.floor(x)
    xf = x - xi
    scale = (torch.clamp(xi.to(torch.int32) + 127, 0, 254) << 23).view(torch.float32)
    c = EXP2_C
    return scale * (c[0] + xf * (c[1] + xf * (c[2] + xf * (c[3] + xf * c[4]))))


def schraudolph_exp2(s: torch.Tensor) -> torch.Tensor:
    """Mode ``sexp``: s·2^23 + 127·2^23 in fp32, truncated toward zero into
    int32 and read as fp32."""
    return (s * 8388608.0 + 1065353216.0).to(torch.int32).view(torch.float32)


def cubic_exp2(s: torch.Tensor) -> torch.Tensor:
    """Mode ``pexp``: the exact exponent by the bit trick times a cubic of
    the fraction (no clamp)."""
    xi = torch.floor(s)
    xf = s - xi
    scale = ((xi.to(torch.int32) + 127) << 23).view(torch.float32)
    return scale * (1.0 + xf * (0.6951937 + xf * (0.2288332 + xf * 0.0779731)))


def parse_variant(variant: str, n: int):
    """``(kind, arg)`` of a ``bench_spatial_variants`` variant at ``n``
    tokens: ``("ilv", nomask)``, ``("chunk", nc)`` or ``("sbf16", (fast,
    ceiling))``.  Raises ``ValueError`` where ``run_variant`` raises or
    asserts (``:199-212``)."""
    if variant in ("ilv", "nomask"):
        return "ilv", variant == "nomask"
    if variant in ("sbf16", "sbf16:fast", "ceiling"):
        return "sbf16", (variant.endswith(":fast"), variant == "ceiling")
    if variant.startswith("chunk"):
        nc = int(variant[5:])
        n_pad_q = _round_up(n, 16)
        if nc < 1 or n_pad_q % nc or (n_pad_q // nc) % 8:
            raise ValueError(f"{variant}: {n_pad_q} query rows do not split into {nc} chunks "
                             "of a multiple of 8 rows")
        return "chunk", nc
    raise ValueError(variant)


def _check_layout(q, k, v, n_valid: int, num_heads: int) -> None:
    b, n, hd = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k and v must share the (B, N, H·D) shape")
    if n_valid != n:
        raise ValueError(f"run_variant masks at the token count of q ({n}); n_valid={n_valid}")
    if num_heads % 2 or hd % num_heads:
        raise ValueError(f"the probes pair heads: {num_heads} heads over {hd} lanes")


def spatial_kernel_plain(kind: str, arg, q, k, v, scale: float, num_heads: int) -> torch.Tensor:
    """The TPU kernel ``(kind, arg)`` of ``parse_variant`` over ``(B, N,
    H·D)``, head by head, with ``run_variant``'s prescale and padding.  k
    and v may hold another token count than q (``chip_smoke.py``'s
    mutants): the key mask and the pad correction follow k's."""
    b, n, hd = q.shape
    nk = k.shape[1]
    d, dt = hd // num_heads, q.dtype
    n_pad_q, n_pad = _round_up(n, 16), _round_up(nk, 128)
    qp = F.pad((q.float() * (scale * LOG2E)).to(dt), (0, 0, 0, n_pad_q - n))
    kp, vp = (F.pad(t, (0, 0, 0, n_pad - nk)) for t in (k, v))
    valid = torch.arange(n_pad, device=q.device) < nk
    out = torch.empty((b, n_pad_q, hd), dtype=dt, device=q.device)
    for h in range(num_heads):
        sl = slice(h * d, (h + 1) * d)
        s = qp[..., sl].float() @ kp[..., sl].float().mT
        if kind == "sbf16" and arg[1]:  # ceiling: no softmax
            p = s
            l = torch.full_like(s[..., :1], float(n_pad))
        elif kind == "sbf16":
            sb = torch.where(valid, s.to(torch.bfloat16),
                             torch.tensor(_NEG, dtype=torch.bfloat16, device=q.device))
            if not arg[0]:
                sb = sb - sb.amax(-1, keepdim=True)  # rounded to bf16, as the TPU's
            p = exp2_poly(sb.float())
            l = p.sum(-1, keepdim=True)
        else:
            nomask = kind == "chunk" or arg
            if not nomask:
                s = torch.where(valid, s, _NEG)
            p = exp2_poly(s)
            l = p.sum(-1, keepdim=True)
            if nomask:  # zero pad keys score 0, p = exp2_poly(0): a constant per pad key
                l = l - float(n_pad - nk)
        acc = p.to(dt).float() @ vp[..., sl].float()
        out[..., sl] = (acc / l).to(dt)
    return out[:, :n]


def spatial_variant_plain(variant: str, q, k, v, scale: float, n_valid: int,
                          num_heads: int) -> torch.Tensor:
    """``run_variant(variant, q, k, v, scale=, n_valid=, num_heads=)`` of
    ``bench_spatial_variants.py`` in plain PyTorch: ``(B, N, H·D)`` in and
    out."""
    _check_layout(q, k, v, n_valid, num_heads)
    kind, arg = parse_variant(variant, q.shape[1])
    return spatial_kernel_plain(kind, arg, q, k, v, scale, num_heads)


def softmax_chain_plain(mode: str, q, k, v) -> torch.Tensor:
    """``kern`` of ``bench_softmax_chain.py`` for ``mode``: q ``(BH, Nq,
    D)``, k ``(BH, Nk, D)``, v ``(BH, Nk, Dv)``, Dv ≥ D → the unnormalised
    ``(P·V)[:, :, :D]`` in q's dtype.  fp32 scores (bf16 for ``bf16s`` and
    ``bf16x``, whose chains then run in bf16), no mask."""
    if mode not in CHAIN_MODES:
        raise ValueError(mode)
    d = q.shape[-1]
    s = q.float() @ k.float().mT
    if mode in ("bf16s", "bf16x"):
        s = s.to(torch.bfloat16)
    if mode == "gemms":
        p = s
    elif mode == "exact":
        p = torch.exp(s - s.amax(-1, keepdim=True))
    elif mode == "sexp":
        p = schraudolph_exp2(s)
    elif mode == "pexp":
        p = cubic_exp2(s)
    elif mode == "bf16x":
        p = torch.exp2(s - s.amax(-1, keepdim=True))
    else:  # exp, bf16s
        p = torch.exp2(s)
    return (p.to(v.dtype).float() @ v[..., :d].float()).to(q.dtype)


_fns = {}


def _kernel(name: str):
    if name not in _fns:
        fn = getattr(cuda_build.library("attention_variants_hopper"), f"vda_{name}")
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if name == "chain":
            fn.argtypes = [vp] * 4 + [i] * 5 + [vp]
        else:  # ilv, chunk, sbf16: q, k, v, o, B, n, heads, qscale, two flags, stream
            fn.argtypes = [vp] * 4 + [i] * 3 + [f, i, i, vp]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _launch_spatial(name: str, q, k, v, scale: float, num_heads: int, a: int, b: int):
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError(f"{name} kernel takes bf16")
    if q.shape[-1] != 64 * num_heads:
        raise NotImplementedError(f"{name} kernel takes head_dim 64, got {q.shape[-1] // num_heads}")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError(f"{name}: operands must share a device")
    q, k, v = (t.contiguous() for t in (q, k, v))
    bsz, n, _ = q.shape
    for t in (q, k, v):  # the kernels' tensor maps (D, H, N, B)
        tma_geometry(t.view(bsz, n, num_heads, 64))
    out = torch.empty_like(q)
    err = _kernel(name)(*(cuda_build.ptr(t) for t in (q, k, v, out)), bsz, n, num_heads,
                        float(scale * LOG2E), a, b, cuda_build.stream_of(q))
    cuda_build.check(err, name)
    return out


def ilv_attention(q, k, v, scale: float, num_heads: int, nomask: bool = False):
    """Variants ``ilv`` (key mask) and ``nomask`` (pad correction)."""
    cuda_build.no_history("ilv_attention", q, k, v)
    _check_layout(q, k, v, q.shape[1], num_heads)
    if q.device.type == "cpu":
        return spatial_kernel_plain("ilv", nomask, q, k, v, scale, num_heads)
    out = _launch_spatial("ilv", q, k, v, scale, num_heads, int(nomask), 0)
    ilv_attention.launches += 1
    return out


def chunk_attention(q, k, v, scale: float, num_heads: int, nc: int):
    """Variant ``chunk<nc>``; the domain is checked by ``parse_variant``."""
    cuda_build.no_history("chunk_attention", q, k, v)
    _check_layout(q, k, v, q.shape[1], num_heads)
    parse_variant(f"chunk{nc}", q.shape[1])
    if q.device.type == "cpu":
        return spatial_kernel_plain("chunk", nc, q, k, v, scale, num_heads)
    out = _launch_spatial("chunk", q, k, v, scale, num_heads, int(nc), 0)
    chunk_attention.launches += 1
    return out


def sbf16_attention(q, k, v, scale: float, num_heads: int, fast: bool = False,
                    ceiling: bool = False):
    """Variants ``sbf16`` (exact), ``sbf16:fast`` and ``ceiling``."""
    cuda_build.no_history("sbf16_attention", q, k, v)
    _check_layout(q, k, v, q.shape[1], num_heads)
    if q.device.type == "cpu":
        return spatial_kernel_plain("sbf16", (fast, ceiling), q, k, v, scale, num_heads)
    out = _launch_spatial("sbf16", q, k, v, scale, num_heads, int(fast), int(ceiling))
    sbf16_attention.launches += 1
    return out


ilv_attention.launches = 0
chunk_attention.launches = 0
sbf16_attention.launches = 0


def spatial_variant(variant: str, q, k, v, scale: float, n_valid: int, num_heads: int):
    """``run_variant``'s counterpart: the variant's domain is checked first
    (``ValueError``), then its wrapper runs."""
    _check_layout(q, k, v, n_valid, num_heads)
    kind, arg = parse_variant(variant, q.shape[1])
    if kind == "ilv":
        return ilv_attention(q, k, v, scale, num_heads, nomask=arg)
    if kind == "chunk":
        return chunk_attention(q, k, v, scale, num_heads, arg)
    return sbf16_attention(q, k, v, scale, num_heads, fast=arg[0], ceiling=arg[1])


def softmax_chain(mode: str, q, k, v) -> torch.Tensor:
    """``kern`` for ``mode``; CPU tensors take ``softmax_chain_plain``, CUDA
    tensors launch the chain kernel (D = 64, Nk a multiple of 64) or
    raise."""
    cuda_build.no_history("softmax_chain", q, k, v)
    if mode not in CHAIN_MODES:
        raise ValueError(mode)
    if q.device.type == "cpu":
        return softmax_chain_plain(mode, q, k, v)
    bh, nq, d = q.shape
    nk, dv = k.shape[1], v.shape[2]
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError("softmax_chain kernel takes bf16")
    if d != 64 or k.shape != (bh, nk, d) or v.shape[:2] != (bh, nk) or dv < d or dv % 8:
        raise NotImplementedError("softmax_chain kernel takes q (BH, Nq, 64), k (BH, Nk, 64) and "
                                  "v (BH, Nk, Dv) with Dv >= 64 a multiple of 8")
    if nk % 64:
        raise NotImplementedError(f"softmax_chain kernel has no key mask: Nk={nk} must be a "
                                  "multiple of 64")
    if any(t.device != q.device for t in (k, v)):
        raise ValueError("softmax_chain: operands must share a device")
    q, k, v = (t.contiguous() for t in (q, k, v))
    for t in (q, k, v[..., :d]):  # the tensor maps (64, 1, N, BH); V's of row stride Dv
        tma_geometry(t.unsqueeze(2))
    out = torch.empty_like(q)
    err = _kernel("chain")(*(cuda_build.ptr(t) for t in (q, k, v, out)), bh, nq, nk, dv,
                           CHAIN_MODES.index(mode), cuda_build.stream_of(q))
    cuda_build.check(err, "softmax_chain")
    softmax_chain.launches += 1
    return out


softmax_chain.launches = 0
