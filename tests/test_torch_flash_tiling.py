"""The tilings of Kernel A's Hopper kernels (``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu``), emulated in torch on the CPU, against the
JAX flash kernels run as the JAX package's tests run them (Pallas
interpret mode): the forward's 128-query CTAs over 128-key tiles at D = 64
and 64-key tiles at D = 192 (S summed over three 64-column panels, O kept
as three), with the zero-filled ragged last tile masked there only, P
rounded to bf16 per tile and 1/l deferred, exact and fast; the backward's dK/dV CTAs of 128 keys
over 64-query tiles and dQ CTAs of 128 queries over 64-key tiles, from the
forward's exp2-domain log-sum-exp and the pre-pass's padded lse (+inf) and
Δ (0).  Also ``chip_smoke.py``'s zero-pad mutant and ``tma_geometry``."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from video_depth_anything_torch.ops import flash_attention as t_flash
from video_depth_anything_tpu.ops.pallas_attention import (
    flash_attention_native,
    spatial_flash_attention,
)
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FWD_TOL = dict(rtol=2e-3, atol=2e-3)  # tests/test_torch_flash_attention.py's bound
BWD_FP32_TOL = dict(rtol=1e-3, atol=1e-4)  # tests/test_torch_flash_attention_bwd.py's
BWD_BF16_TOL = 3e-2  # of max|want| per gradient, as there
ROWS = 128  # forward: queries per CTA, and keys per tile at D = 64; backward: rows a CTA keeps
STEP = 64  # backward: rows of a streamed tile; forward: keys per tile at D = 192


def _pad_rows(x, rows: int):
    """(B, N, H, D) → (B, H, rows, D) fp32, zero rows past N (as TMA fills them)."""
    return F.pad(x.float(), (0, 0, 0, 0, 0, rows - x.shape[1])).permute(0, 2, 1, 3)


def tiled_forward(q, k, v, scale, fast=False, mask=True):
    """``(out, lse)`` of the forward kernel's tiling (``flash_fwd_hopper`` at
    D = 64, ``flash_fwd_hopper192`` at D = 192); ``mask=False`` counts the
    zero-filled pad keys (the ``unmasked_zero_pad`` mutant)."""
    b, n, h, d = q.shape
    keys = ROWS if d == 64 else STEP
    n_pad = -(-n // ROWS) * ROWS
    k_pad = -(-n // keys) * keys
    qp = _pad_rows(q, n_pad)
    kp, vp = (_pad_rows(x, k_pad) for x in (k, v))
    sl2 = scale * t_flash.LOG2E
    # The CTAs (128 queries each) are independent: all of them in one tensor
    # op, each row over the same key tiles in the kernel's order.
    m = torch.full((b, h, n_pad), 0.0 if fast else -math.inf)
    l = torch.zeros(b, h, n_pad)
    acc = torch.zeros(b, h, n_pad, d)
    for j in range(0, k_pad, keys):
        kj = kp[:, :, j:j + keys]
        s = sum(qp[..., c:c + 64] @ kj[..., c:c + 64].transpose(-1, -2)  # 64-column panels
                for c in range(0, d, 64)) * sl2
        if mask and n - j < keys:  # the ragged last tile only
            s[..., n - j:] = -math.inf
        if not fast:
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - m_new)
            acc, l, m = acc * alpha[..., None], l * alpha, m_new
        p = torch.exp2(s - m[..., None])
        l = l + p.sum(-1)
        acc = acc + p.to(torch.bfloat16).float() @ vp[:, :, j:j + keys]
    out = acc / l[..., None]
    lse = m + torch.log2(l)
    return out[:, :, :n].permute(0, 2, 1, 3).to(q.dtype), lse[:, :, :n]


def tiled_backward(q, k, v, o, lse, g, scale):
    """``(dq, dk, dv)`` of the backward kernels' tiling, rounding P and dS
    to the input dtype where the kernels round them to bf16."""
    b, n, h, d = q.shape
    dt = q.dtype
    n_pad = -(-n // ROWS) * ROWS
    qp, kp, vp, gp = (_pad_rows(x, n_pad) for x in (q, k, v, g))
    sl2 = scale * t_flash.LOG2E
    # the pre-pass: Δ = rowsum(dO ⊙ O) and lse, padded with 0 and +inf
    delta = F.pad((g.float() * o.float()).sum(-1).permute(0, 2, 1), (0, n_pad - n))
    lse_p = F.pad(lse, (0, n_pad - n), value=math.inf)
    dq, dk, dv = (torch.zeros(b, h, n_pad, d) for _ in range(3))
    for c in range(0, n_pad, ROWS):  # dK/dV: a CTA of 128 keys over 64-query tiles
        kc, vc = kp[:, :, c:c + ROWS], vp[:, :, c:c + ROWS]
        for i in range(0, n, STEP):
            qi, gi = qp[:, :, i:i + STEP], gp[:, :, i:i + STEP]
            pt = torch.exp2(kc @ qi.transpose(-1, -2) * sl2 - lse_p[:, :, None, i:i + STEP])
            dv[:, :, c:c + ROWS] += pt.to(dt).float() @ gi
            dst = pt * (vc @ gi.transpose(-1, -2) - delta[:, :, None, i:i + STEP])
            dk[:, :, c:c + ROWS] += dst.to(dt).float() @ qi
    for c in range(0, n_pad, ROWS):  # dQ: a CTA of 128 queries over 64-key tiles
        qc, gc = qp[:, :, c:c + ROWS], gp[:, :, c:c + ROWS]
        for j in range(0, n, STEP):
            kj, vj = kp[:, :, j:j + STEP], vp[:, :, j:j + STEP]
            p = torch.exp2(qc @ kj.transpose(-1, -2) * sl2 - lse_p[:, :, c:c + ROWS, None])
            if n - j < STEP:  # the ragged last key tile: zero keys score 0
                p[..., n - j:] = 0.0
            ds = p * (gc @ vj.transpose(-1, -2) - delta[:, :, c:c + ROWS, None])
            dq[:, :, c:c + ROWS] += ds.to(dt).float() @ kj
    back = lambda x, mul: (x[:, :, :n] * mul).permute(0, 2, 1, 3).to(dt)  # noqa: E731
    return back(dq, scale), back(dk, scale), back(dv, 1.0)


def _qkv(seed, b, n, h, qk_std=0.5, d=64):
    rng = np.random.RandomState(seed)
    q, k = (rng.randn(b, n, h, d).astype(np.float32) * qk_std for _ in range(2))
    v, g = (rng.randn(b, n, h, d).astype(np.float32) for _ in range(2))
    return q, k, v, g


def _jax_forward(q, k, v, fast):
    """The JAX package's dispatch: the native-layout kernel for even heads
    and at most 2048 padded keys, the blocked (or whole-row) kernel else."""
    b, n, h, d = q.shape
    if h % 2 == 0 and -(-n // 128) * 128 <= 2048:
        out = flash_attention_native(*(jnp.asarray(x.reshape(b, n, h * d)) for x in (q, k, v)),
                                     scale=d**-0.5, n_valid=n, num_heads=h, fast_softmax=fast,
                                     interpret=True)
        return np.asarray(out).reshape(b, n, h, d)
    return np.asarray(spatial_flash_attention(*(jnp.asarray(x) for x in (q, k, v)), d**-0.5,
                                              fast_softmax=fast, interpret=True))


@pytest.mark.parametrize("n,h,fast", [
    (362, 2, False), (362, 2, True),  # native layout, 3 tiles
    (1370, 2, False),                 # native layout, 11 tiles
    (1370, 3, False),                 # odd heads: the whole-row kernel
    (2443, 3, False), (2443, 3, True),  # blocked kernel (512-key blocks)
])
def test_forward_tiling_matches_jax_kernels(n, h, fast):
    q, k, v, _ = _qkv(n + h + fast, 1, n, h)
    want = _jax_forward(q, k, v, fast)
    got, _ = tiled_forward(*map(torch.from_numpy, (q, k, v)), 64**-0.5, fast=fast)
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


@pytest.mark.parametrize("n,h,fast", [(n, h, fast) for n in (300, 1370, 2443) for h in (1, 2)
                                       for fast in (False, True)])
def test_forward_tiling_at_d192_matches_jax_kernels(n, h, fast):
    """D = 192: the whole-row kernel at n = 300 and 1370, the blocked one
    (512-key blocks) at 2443; 64-key tiles, ragged at all three."""
    q, k, v, _ = _qkv(n + h + fast, 1, n, h, d=192)
    want = _jax_forward(q, k, v, fast)
    got, _ = tiled_forward(*map(torch.from_numpy, (q, k, v)), 192**-0.5, fast=fast)
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


def test_forward_tiling_lse_is_the_exp2_log_sum_exp():
    q, k, v, _ = map(torch.from_numpy, _qkv(5, 1, 300, 2, qk_std=1.6))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * 0.125
    want = torch.logsumexp(s, -1) / math.log(2.0)
    for fast in (False, True):
        _, lse = tiled_forward(q, k, v, 0.125, fast=fast)
        torch.testing.assert_close(lse, want, rtol=0, atol=1e-4)


def _jax_vjp(q, k, v, g, dtype):
    b, n, h, d = q.shape
    flat = lambda x: jnp.asarray(x.reshape(b, n, h * d), dtype)  # noqa: E731
    out, vjp = jax.vjp(lambda q_, k_, v_: flash_attention_native(
        q_, k_, v_, scale=d**-0.5, n_valid=n, num_heads=h, bwd_impl="pallas", interpret=True),
        flat(q), flat(k), flat(v))
    to_np = lambda x: np.array(x.astype(jnp.float32)).reshape(b, n, h, d)  # noqa: E731
    return to_np(out), [to_np(x) for x in vjp(flat(g))]


@pytest.mark.parametrize("n,h", [(362, 2), (300, 6)])  # ragged tiles; 300: one dQ CTA of pads
def test_backward_tiling_matches_pallas_backward(n, h):
    q, k, v, g = _qkv(n * h, 1, n, h, qk_std=1.6)
    out, want = _jax_vjp(q, k, v, g, jnp.float32)
    tq, tk, tv, tg, to = map(torch.from_numpy, (q, k, v, g, out))
    _, lse = tiled_forward(tq, tk, tv, 64**-0.5)
    got = tiled_backward(tq, tk, tv, to, lse, tg, 64**-0.5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, **BWD_FP32_TOL)


def test_backward_tiling_in_bf16_within_bound_of_pallas_backward():
    q, k, v, g = _qkv(9, 1, 362, 2, qk_std=1.6)
    out, want = _jax_vjp(q, k, v, g, jnp.bfloat16)
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16)  # noqa: E731
    tq, tk, tv, tg, to = map(bf, (q, k, v, g, out))
    _, lse = tiled_forward(tq, tk, tv, 64**-0.5)
    got = tiled_backward(tq, tk, tv, to, lse, tg, 64**-0.5)
    for a, b in zip(got, want):
        assert chip_smoke.rel_err(a, torch.from_numpy(b)) <= BWD_BF16_TOL


@pytest.mark.parametrize("n", [362, 1370])  # the ragged shapes of phase kernels: 22, 38 pad keys
def test_zero_pad_mutant_separates_right_from_wrong(n):
    """chip_smoke.py's second check of Kernel A, on flat inputs: the JAX
    kernel (a right implementation) is within ATTN_TOL of the plain
    version; the tiling that counts the zero-filled pad keys misses by
    more, by as much as ``zero_pad_error`` says."""
    b, h, d = 1, 2, 64
    qkv = chip_smoke.attention_inputs((b, n, h * d), torch.Generator().manual_seed(n), "cpu")
    q, k, v = (x.reshape(b, n, h, d) for x in qkv.split(h * d, dim=-1))
    q = chip_smoke.flat_inputs(q)
    want = t_flash.flash_attention_plain(q, k, v, d**-0.5)
    right = torch.from_numpy(np.asarray(spatial_flash_attention(
        *(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)), d**-0.5,
        interpret=True), np.float32))
    assert chip_smoke.rel_err(right, want) <= chip_smoke.ATTN_TOL
    assert chip_smoke.rel_err(tiled_forward(q, k, v, d**-0.5)[0], want) <= chip_smoke.ATTN_TOL
    err = chip_smoke.zero_pad_error(t_flash.flash_attention_plain, q, k, v, d**-0.5, ROWS)
    assert err > chip_smoke.ATTN_TOL
    unmasked = chip_smoke.rel_err(tiled_forward(q, k, v, d**-0.5, mask=False)[0], want)
    assert unmasked > chip_smoke.ATTN_TOL
    assert abs(unmasked - err) <= 0.1 * err


@pytest.mark.parametrize("n", [1370, 2443])  # phase kernels' D = 192 rows: 38, 53 pad keys of 64-key tiles
def test_zero_pad_mutant_at_d192_separates_right_from_wrong(n):
    """The same check at D = 192, whose pad keys fill the last 64-key tile."""
    b, h, d = 1, 1, 192
    qkv = chip_smoke.attention_inputs((b, n, h * d), torch.Generator().manual_seed(n), "cpu")
    q, k, v = (x.reshape(b, n, h, d) for x in qkv.split(h * d, dim=-1))
    q = chip_smoke.flat_inputs(q)
    want = t_flash.flash_attention_plain(q, k, v, d**-0.5)
    assert chip_smoke.rel_err(tiled_forward(q, k, v, d**-0.5)[0], want) <= chip_smoke.ATTN_TOL
    err = chip_smoke.zero_pad_error(t_flash.flash_attention_plain, q, k, v, d**-0.5, STEP)
    assert err > chip_smoke.ATTN_TOL
    unmasked = chip_smoke.rel_err(tiled_forward(q, k, v, d**-0.5, mask=False)[0], want)
    assert abs(unmasked - err) <= 0.1 * err


@pytest.mark.parametrize("h", [3, 6, 12, 16])
def test_tma_geometry_of_the_fused_qkv_views(h):
    b, n, d = 2, 300, 64
    qkv = torch.zeros(b, n, 3 * h * d, dtype=torch.bfloat16)
    for part in qkv.split(h * d, dim=-1):
        dims, strides = t_flash.tma_geometry(part.view(b, n, h, d))
        assert dims == (d, h, n, b)
        assert strides == (d * 2, 3 * h * d * 2, n * 3 * h * d * 2)


@pytest.mark.parametrize("h", [1, 2, 3])
def test_tma_geometry_of_the_fused_qkv_views_at_d192(h):
    """The (192, H, N, B) maps of ``flash_fwd_hopper192``: three 64-column
    panels a row, 384-byte head strides."""
    b, n, d = 2, 300, 192
    qkv = torch.zeros(b, n, 3 * h * d, dtype=torch.bfloat16)
    for part in qkv.split(h * d, dim=-1):
        dims, strides = t_flash.tma_geometry(part.view(b, n, h, d))
        assert dims == (d, h, n, b)
        assert strides == (d * 2, 3 * h * d * 2, n * 3 * h * d * 2)
        assert d % 64 == 0 and all(s % 16 == 0 for s in strides)


def test_tma_geometry_refuses_what_a_map_cannot_describe():
    b, n, h, d = 1, 300, 6, 64
    x = torch.zeros(b, n, 3 * h * d + 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned base"):
        t_flash.tma_geometry(x[..., 1:1 + h * d].view(b, n, h, d))
    y = torch.zeros(b, n, h * d + 1, dtype=torch.bfloat16)  # token stride 2 bytes off 16
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        t_flash.tma_geometry(y[..., :h * d].view(b, n, h, d))
    with pytest.raises(ValueError, match="unit stride"):
        t_flash.tma_geometry(torch.zeros(b, n, d, h, dtype=torch.bfloat16).transpose(2, 3))
