"""The plan of Kernel C at C = 768 and 1024 (``csrc/motion_module_wide.cu``),
emulated in torch on the CPU in bf16, against the port's plain version and
the JAX Pallas motion kernel run as the JAX package's tests run it
(interpret mode), with the wrong plans it must tell apart.

The plan: a chain of launches over the M = B·T·S token rows in (b, t, s)
order, the activations in a device-memory scratch between them.  Row norms
(the folded GroupNorm; LayerNorm, rounded to bf16, then + APE, rounded
again); each product over 128-row tiles (rows past M read as zero, never
stored: the last tile ragged) and 128-column weight tiles, k panel after k
panel of ``weight_blocks_wide`` (un-swizzled here, read in launch order)
into fp32 accumulators, its epilogue fused (bias; residual re-read from y;
GEGLU from a tile's 64 h and 64 gate columns); q | k | v as one product of
3C columns; the frame attention per (location, head) over T padded up to
Tp = 8, 16 or 32 key frames (those past T masked), p rounded to bf16 once
normalised, its out over h.  ``emulate_wide`` also serves the fp32 plan
(``tests/test_torch_motion_wide_f32_tiling.py``): every product in 3xTF32
over ``wide_tiles_f32``'s hi and lo tiles, no rounding, the erf GELU."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_depth_anything_torch.config import MotionModuleConfig as TCfg
from video_depth_anything_torch.ops import motion_module as t_motion
from video_depth_anything_tpu.config import MotionModuleConfig as JCfg
from video_depth_anything_tpu.ops.pallas_motion import fused_motion_module
from tests.test_torch_motion_tiling import TOL, _params, _rel, _x
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BM, BN = t_motion.WIDE_BM, t_motion.WIDE_BN


def unswizzle(tiles: torch.Tensor, chunk: int) -> torch.Tensor:
    """``(..., rows, 8·chunk)`` tiles whose row n holds logical 16-byte chunk
    j at chunk ``j ^ (n % 8)`` → the plain rows."""
    rows = tiles.shape[-2]
    src = torch.arange(8)[None, :] ^ (torch.arange(rows) % 8)[:, None]
    t = tiles.reshape(-1, rows, 8, chunk)
    out = torch.empty_like(t)
    out[:, torch.arange(rows)[:, None], src] = t
    return out.reshape(tiles.shape)


class Tiles:
    """The weight sequence as the chain reads it: product after product, a
    ``(K, N)`` product's (N/128)·(K/KW) tiles (bf16) or hi/lo tile pairs
    (fp32), each launch taking the next product's share."""

    def __init__(self, flat: torch.Tensor):
        self.flat, self.off = flat, 0
        self.f32 = flat.dtype == torch.float32

    def next(self, k: int, n: int) -> torch.Tensor:
        """``(N/128, K/KW, [2,] 128, KW)`` un-swizzled tiles of the next product."""
        kw = 32 if self.f32 else 64
        shape = (n // BN, k // kw) + ((2,) if self.f32 else ()) + (BN, kw)
        count = int(np.prod(shape))
        t = self.flat[self.off:self.off + count].reshape(shape)
        self.off += count
        return unswizzle(t, 4 if self.f32 else 8).float()


def tf32(x):
    return t_motion.tf32_rna(x.contiguous())


def gemm(a: torch.Tensor, tiles: torch.Tensor) -> torch.Tensor:
    """``a (M, K)`` times the product's tiles, as the GEMM launch computes
    it: 128-row tiles (the last padded with zero rows: TMA's fill), one
    fp32 accumulator over the k panels in order (bf16: the panel's exact
    products; fp32: lo·hi + hi·lo + hi·hi of the split operands); rows past
    M dropped."""
    m, k = a.shape
    nb, kp = tiles.shape[:2]
    kw = tiles.shape[-1]
    f32 = tiles.dim() == 5
    rows = -(-m // BM) * BM
    ap = torch.zeros(rows, k)
    ap[:m] = a
    acc = torch.zeros(rows, nb * BN)
    for p in range(kp):
        ak = ap[:, p * kw:(p + 1) * kw]
        if f32:
            hi = tf32(ak)
            lo = tf32(ak - hi)
            wh = tiles[:, p, 0].reshape(nb * BN, kw).t()
            wl = tiles[:, p, 1].reshape(nb * BN, kw).t()
            acc += lo @ wh + hi @ wl + hi @ wh
        else:
            acc += ak @ tiles[:, p].reshape(nb * BN, kw).t()
    return acc[:m]


def emulate_wide(x, p, cfg, heads, mutant=None):
    """The chain's result on ``x (B, T, S, C)`` (bf16 or fp32; returned as
    fp32).  ``mutant``: ``"unmasked_keys"`` lets the padded frames' zero keys
    into the softmax; ``"k_from_next_head"`` reads each head's keys from the
    next head's columns; ``"residual_not_reread"`` drops y from the out
    projection's residual epilogue."""
    b_, t_, s_, c = x.shape
    f32 = x.dtype == torch.float32
    rnd = (lambda v: v) if f32 else (lambda v: v.to(torch.bfloat16).float())  # noqa: E731
    tp = t_motion.padded_frames(t_)
    w = t_motion.kernel_weights(p, cfg, x.dtype)
    assert w["w"].numel() == 22 * c * c * (2 if f32 else 1)
    gna, gnb = t_motion.gn_fold(x, w, cfg)
    fw = {k: w[k].float() for k in ("b_in", "ln_scale", "ln_bias", "bo", "b1", "b2", "b_out")}
    pe = w["pe"].float()
    seq = Tiles(w["w"])
    m, d = b_ * t_ * s_, c // heads
    xr = x.float().reshape(m, c)
    bt = torch.arange(m) // s_  # (b, t) of each row
    t_of = bt % t_

    def ln(y, i, ape):
        mean = y.mean(-1, keepdim=True)
        var = torch.clamp((y * y).mean(-1, keepdim=True) - mean * mean, min=0.0)
        h = rnd((y - mean) * (torch.rsqrt(var + cfg.layer_norm_eps) * fw["ln_scale"][i])
                + fw["ln_bias"][i])
        return rnd(h + pe[t_of]) if ape else h

    def attention(qkv):
        """(M, 3C) → (M, C): per (b, s, head) a Tp-row tile, rows past T zero."""
        t4 = torch.zeros(b_, tp, s_, 3, heads, d)
        t4[:, :t_] = qkv.reshape(b_, t_, s_, 3, heads, d)
        q, k, v = (t4[:, :, :, j].permute(0, 2, 3, 1, 4) for j in range(3))  # (B, S, H, Tp, d)
        if mutant == "k_from_next_head":
            k = k.roll(-1, dims=2)
        sc = q @ k.transpose(-1, -2) * d**-0.5
        if mutant != "unmasked_keys":
            sc[..., t_:] = -torch.inf
        e = torch.exp(sc - sc.amax(-1, keepdim=True))
        l = e.sum(-1, keepdim=True)
        o = rnd(rnd(e / l) @ v) if not f32 else (e @ v) / l
        return o.permute(0, 3, 1, 2, 4)[:, :t_].reshape(m, c)  # query rows past T: not stored

    def act(hh, gg):
        if f32:
            return (hh + fw["b1"][:4 * c]) * torch.nn.functional.gelu(gg + fw["b1"][4 * c:])
        g = rnd(gg + fw["b1"][4 * c:])
        ge = rnd(0.5 * g * (1 + torch.tanh(0.7978845608028654 * (g + 0.044715 * g**3))))
        return rnd(rnd(hh + fw["b1"][:4 * c]) * ge)

    h = rnd(xr * gna.reshape(-1, c)[bt] + gnb.reshape(-1, c)[bt])
    y = rnd(gemm(h, seq.next(c, c)) + fw["b_in"])
    for i in range(2):
        h = ln(y, i, True)
        qkv = rnd(gemm(h, seq.next(c, 3 * c)))
        h = attention(qkv)  # over h
        part = gemm(h, seq.next(c, c)) + fw["bo"][i]
        y = rnd(part if mutant == "residual_not_reread" else y + part)
    h = ln(y, 2, False)
    ff = gemm(h, seq.next(c, 8 * c)).reshape(m, 4 * c // 64, 2, 64)
    a = act(ff[:, :, 0].reshape(m, 4 * c), ff[:, :, 1].reshape(m, 4 * c))
    y = rnd(y + gemm(a, seq.next(4 * c, c)) + fw["b2"])
    out = rnd(gemm(y, seq.next(c, c)) + fw["b_out"] + xr)
    assert seq.off == seq.flat.numel()
    return out.reshape(b_, t_, s_, c)


@functools.lru_cache(maxsize=None)
def _case(c, t, s):
    """Parameters, x and the plan's output of a shape, computed once for the
    plain and the Pallas comparisons."""
    p, x = _params(c, c + t), _x(c, t, s, s)
    return p, x, emulate_wide(x, p, TCfg(), 8)


# M = T·S rows leave the last 128-row GEMM tile ragged (168, 156, 180, 160);
# T = 12 and 20 take Tp = 16 and 32
CASES = [(c, t, s) for c in (768, 1024) for t, s in ((8, 21), (12, 13), (20, 9), (32, 5))]


@pytest.mark.parametrize("c,t,s", CASES)
def test_wide_plan_matches_plain(c, t, s):
    p, x, got = _case(c, t, s)
    assert (t * s) % BM
    want = t_motion.motion_module_plain(x, p, TCfg(), 8)
    assert _rel(got, want, x) <= TOL


@pytest.mark.parametrize("c", [768, 1024])
def test_wide_plan_matches_pallas_kernel(c):
    p, x, got = _case(c, 32, 5)
    want = fused_motion_module(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                               {k: jnp.asarray(v.numpy()) for k, v in p.items()},
                               heads=8, cfg=JCfg(), interpret=True)
    assert _rel(got, torch.from_numpy(np.asarray(want, np.float32)), x) <= TOL


@pytest.mark.parametrize("mutant,c,t,s", [("unmasked_keys", 768, 20, 9),
                                          ("k_from_next_head", 1024, 12, 13),
                                          ("residual_not_reread", 768, 8, 21)])
def test_wrong_wide_plans_miss_plain(mutant, c, t, s):
    """The padded frames' keys let in (T = 20 in 32 rows), each head's keys
    read from the next head's columns of the q | k | v scratch, and the out
    projection's residual not re-read from y: each misses the plain version
    by more than the tolerance."""
    p, x, _ = _case(c, t, s)
    want = t_motion.motion_module_plain(x, p, TCfg(), 8)
    assert _rel(emulate_wide(x, p, TCfg(), 8, mutant=mutant), want, x) > TOL


@pytest.mark.parametrize("c", [768, 1024])
def test_wide_tiles_address_the_jax_weights(c):
    """Product j's tile (column block nb, panel kp) holds at row n, logical
    chunk J stored at chunk J ^ (n % 8), weight (64 kp + k, 128 nb + n) of
    the product's (in, out) weight: proj_in, block 1's q | k | v (k and v
    blocks), w1's interleaved h and gate columns, w2 and proj_out, read
    straight from the JAX-layout parameters."""
    p = _params(c, 7)
    flat = t_motion.weight_blocks_wide(p)
    assert flat.numel() == 22 * c * c and flat.dtype == torch.bfloat16
    offsets = np.cumsum([0, 1, 3, 1, 3, 1, 8, 4]) * c * c  # products' starts, in C² elements

    def stored(prod, k_in, n_out, k_dim):
        nb, n = divmod(n_out, BN)
        kp, k = divmod(k_in, 64)
        tile = offsets[prod] + (nb * (k_dim // 64) + kp) * BN * 64
        return flat[tile + n * 64 + (((k // 8) ^ (n % 8)) * 8) + k % 8]

    bf = lambda v: v.to(torch.bfloat16)  # noqa: E731
    gen = np.random.default_rng(c)
    for _ in range(200):
        k_in, n_out = int(gen.integers(c)), int(gen.integers(c))
        assert stored(0, k_in, n_out, c) == bf(p["w_in"][k_in, n_out])
        assert stored(1, k_in, c + n_out, c) == bf(p["wk"][0, k_in, n_out])
        assert stored(1, k_in, 2 * c + n_out, c) == bf(p["wv"][0, k_in, n_out])
        assert stored(4, k_in, n_out, c) == bf(p["wo"][1, k_in, n_out])
        j = int(gen.integers(4 * c))  # hidden unit j: h column 128 (j // 64) + j % 64, gate + 64
        assert stored(5, k_in, 128 * (j // 64) + j % 64, c) == bf(p["w1"][k_in, j])
        assert stored(5, k_in, 128 * (j // 64) + 64 + j % 64, c) == bf(p["w1"][k_in, 4 * c + j])
        assert stored(6, j, n_out, 4 * c) == bf(p["w2"][j, n_out])
        assert stored(7, k_in, n_out, c) == bf(p["w_out"][k_in, n_out])
