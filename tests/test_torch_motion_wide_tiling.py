"""The plan of Kernel C's wide chain (``csrc/motion_module_wide.cu``: C = 768
and 1024, and every module off the resident kernels' domain), emulated in
torch on the CPU in bf16, against the port's plain version and the JAX
Pallas motion kernel run as the JAX package's tests run it (interpret
mode), with the wrong plans it must tell apart.

The plan: a chain of launches over the M = B·T·S token rows in (b, t, s)
order, the activations in a device-memory scratch between them.  Row norms
(the folded GroupNorm; LayerNorm, rounded to bf16, then + APE, rounded
again); each product over 128-row tiles (rows past M read as zero, never
stored: the last tile ragged) and BN-column weight tiles (``wide_bn``: 256
in bf16 where N > 128, else 128), walked by persistent CTAs in
``wide_schedule``'s grouped order (each CTA's accumulator zeroed on a
tile's first panel), over ``weight_blocks_wide`` (un-swizzled here, read in
launch order) into fp32 accumulators, its epilogue fused (bias; the
residual y read before the tile is stored over it; GEGLU from a tile's
BN / 2 h and BN / 2 gate columns); q | k | v as one product of 3C columns;
the frame attention per (location, head) over T padded up to Tp = 8, 16 or
32 key frames (those past T masked), p rounded to bf16 once normalised, its
out over h.  The emulation walks the tiles on a few CTAs (``CTAS``), so that
each CTA takes several tiles as the card's 132 do at the real sizes.  ``emulate_wide`` also serves the fp32 plan
(``tests/test_torch_motion_wide_f32_tiling.py``): every product in 3xTF32
over ``wide_tiles_f32``'s hi and lo tiles, no rounding, the erf GELU.

Off the shipped config (the domain plan): the heads, the attention blocks
and the hidden width are run-time values; products whose K is not a whole
number of 64-input (fp32: 32) panels read the TMA's zero fill past K, their
weight tiles are zero-padded to whole panels and 128-column blocks, and the
epilogues store only the product's N columns; the hidden units are padded to
whole halves of the GEGLU tile (``wide_hidden``) with zero weights and
biases.  Held at 4 heads with one
attention block (JAX's KV-cache test config), 16 heads with three blocks
at ff_mult 2, and C = 40 (one ragged panel, one ragged column block) against
the plain version in bf16 and fp32 and against the Pallas kernel on fp32
inputs (rtol 1e-3), with two wrong plans: 8 heads whatever the config says,
and the last attention block dropped."""

import functools
import math

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

BM = t_motion.WIDE_BM
CTAS = 4  # the emulated grid: every CTA walks several tiles


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
    ``(K, N)`` product's ⌈N/BN⌉·⌈K/KW⌉ tiles (bf16) or hi/lo tile pairs
    (fp32), each launch taking the next product's share."""

    def __init__(self, flat: torch.Tensor):
        self.flat, self.off = flat, 0
        self.f32 = flat.dtype == torch.float32

    def next(self, k: int, n: int) -> torch.Tensor:
        """``(⌈N/BN⌉, ⌈K/KW⌉, [2,] BN, KW)`` un-swizzled tiles of the next
        product, BN = ``wide_bn(N)``."""
        kw = 32 if self.f32 else 64
        bn = t_motion.wide_bn(n, self.flat.dtype)
        shape = (-(-n // bn), -(-k // kw)) + ((2,) if self.f32 else ()) + (bn, kw)
        count = int(np.prod(shape))
        t = self.flat[self.off:self.off + count].reshape(shape)
        self.off += count
        return unswizzle(t, 4 if self.f32 else 8).float()


def tf32(x):
    return t_motion.tf32_rna(x.contiguous())


def gemm(a: torch.Tensor, tiles: torch.Tensor, n: int, mutant=None) -> torch.Tensor:
    """``a (M, K)`` times the product's tiles (N = ``n`` columns), as the
    persistent GEMM launch computes it: ``CTAS`` CTAs walk the 128-row ×
    BN-column output tiles in ``wide_schedule``'s order (the last row block
    padded with zero rows: TMA's fill), each tile one fp32 accumulator over
    K, zeroed on its first panel (bf16: the exact products; fp32: lo·hi +
    hi·lo + hi·hi of the split operands), columns past K zero (TMA's fill);
    rows past M and columns past N dropped.  ``mutant``: ``"acc_carried"``
    adds a CTA's previous tile's accumulator (not zeroed on the first
    panel); ``"edge_tile_skipped"`` never stores the walk's last tile (the
    ragged corner)."""
    m, k = a.shape
    nb, kp = tiles.shape[:2]
    bn, kw = tiles.shape[-2:]
    f32 = tiles.dim() == 5
    rows = -(-m // BM) * BM
    ap = torch.zeros(rows, kp * kw)
    ap[:m, :k] = a
    w = tiles.transpose(1, -2).reshape(nb * bn, *tiles.shape[2:-2], kp * kw) if not f32 else \
        tiles.permute(2, 0, 3, 1, 4).reshape(2, nb * bn, kp * kw)
    if f32:
        hi = tf32(ap)
        lo = tf32(ap - hi)
    out = torch.zeros(rows, nb * bn)
    last = t_motion.wide_tile(-(-m // BM) * nb - 1, -(-m // BM), nb)
    for cta in t_motion.wide_schedule(m, n, bn, CTAS):
        acc = None
        for mb, cb in cta:
            r, c = slice(mb * BM, (mb + 1) * BM), slice(cb * bn, (cb + 1) * bn)
            if f32:
                wh, wl = w[0, c].t(), w[1, c].t()
                part = lo[r] @ wh + hi[r] @ wl + hi[r] @ wh
            else:
                part = ap[r] @ w[c].t()
            acc = part + acc if mutant == "acc_carried" and acc is not None else part
            if mutant == "edge_tile_skipped" and (mb, cb) == last:
                continue
            out[r, c] = acc
    return out[:m, :n]


def emulate_wide(x, p, cfg, heads, mutant=None):
    """The chain's result on ``x (B, T, S, C)`` (bf16 or fp32; returned as
    fp32).  ``mutant``: ``"unmasked_keys"`` lets the padded frames' zero keys
    into the softmax; ``"k_from_next_head"`` reads each head's keys from the
    next head's columns; ``"residual_not_reread"`` drops y from the out
    projection's residual epilogue; ``"eight_heads"`` attends with 8 heads
    whatever ``heads`` says; ``"last_block_dropped"`` skips the last
    attention block (its weights still read); ``"acc_carried"`` and
    ``"edge_tile_skipped"`` every product as ``gemm``'s mutants;
    ``"geglu_halves_swapped"`` takes each GEGLU tile's gate columns for its
    h columns and the other way round; ``"residual_after_store"`` reads the
    in-place residual y of the out projections and w2 after the tile was
    stored over it (y + 2 part)."""
    b_, t_, s_, c = x.shape
    f32 = x.dtype == torch.float32
    rnd = (lambda v: v) if f32 else (lambda v: v.to(torch.bfloat16).float())  # noqa: E731
    tp = t_motion.padded_frames(t_)
    n_attn, hidden = cfg.num_attention_blocks, t_motion.wide_hidden(p, x.dtype)
    w = t_motion.kernel_weights(p, cfg, x.dtype)
    assert not t_motion.resident(c, heads, cfg)
    assert w["w"].numel() == t_motion.wide_weight_elems(c, n_attn, hidden, x.dtype)
    if (c, n_attn, hidden) in ((768, 2, 3072), (1024, 2, 4096)):
        assert w["w"].numel() == 22 * c * c * (2 if f32 else 1)
    if mutant == "eight_heads":
        heads = 8
    gna, gnb = t_motion.gn_fold(x, w, cfg)
    fw = {k: w[k].float() for k in ("b_in", "ln_scale", "ln_bias", "bo", "b1", "b2", "b_out")}
    pe = w["pe"].float()
    seq = Tiles(w["w"])
    m, d = b_ * t_ * s_, c // heads
    tile_mutant = mutant if mutant in ("acc_carried", "edge_tile_skipped") else None
    mm = functools.partial(gemm, mutant=tile_mutant)
    twice = 2.0 if mutant == "residual_after_store" else 1.0
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

    def act(hh, gg):  # b1 as wide_b1 lays it: h biases, then gate biases, each of F
        if f32:
            return (hh + fw["b1"][:hidden]) * torch.nn.functional.gelu(gg + fw["b1"][hidden:])
        g = rnd(gg + fw["b1"][hidden:])
        ge = rnd(0.5 * g * (1 + torch.tanh(0.7978845608028654 * (g + 0.044715 * g**3))))
        return rnd(rnd(hh + fw["b1"][:hidden]) * ge)

    h = rnd(xr * gna.reshape(-1, c)[bt] + gnb.reshape(-1, c)[bt])
    y = rnd(mm(h, seq.next(c, c), c) + fw["b_in"])
    for i in range(n_attn):
        h = ln(y, i, True)
        qkv = rnd(mm(h, seq.next(c, 3 * c), 3 * c))
        h = attention(qkv)  # over h
        part = mm(h, seq.next(c, c), c) + fw["bo"][i]
        if mutant == "last_block_dropped" and i == n_attn - 1:
            continue
        y = rnd(part if mutant == "residual_not_reread" else y + twice * part)
    h = ln(y, n_attn, False)
    u = t_motion.wide_bn(2 * hidden, x.dtype) // 2  # units a GEGLU tile
    ff = mm(h, seq.next(c, 2 * hidden), 2 * hidden).reshape(m, hidden // u, 2, u)
    if mutant == "geglu_halves_swapped":
        ff = ff.flip(2)
    a = act(ff[:, :, 0].reshape(m, hidden), ff[:, :, 1].reshape(m, hidden))
    y = rnd(y + twice * mm(a, seq.next(hidden, c), c) + fw["b2"])
    out = rnd(mm(y, seq.next(c, c), c) + fw["b_out"] + xr)
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


@pytest.mark.parametrize("mutant,c,t,s", [("acc_carried", 1024, 8, 21),
                                          ("edge_tile_skipped", 768, 12, 13),
                                          ("geglu_halves_swapped", 1024, 20, 9),
                                          ("residual_after_store", 768, 32, 5)])
def test_wrong_persistent_plans_miss_plain(mutant, c, t, s):
    """The persistent walk's wrong plans: an accumulator carried from a
    CTA's tile into its next (no zeroing on the first panel), the walk's last
    tile (the ragged corner) never stored, each GEGLU tile's h and gate
    halves swapped, and the in-place residual read after the tile was stored
    over it: each misses the plain version by more than the tolerance."""
    p, x, _ = _case(c, t, s)
    want = t_motion.motion_module_plain(x, p, TCfg(), 8)
    assert _rel(emulate_wide(x, p, TCfg(), 8, mutant=mutant), want, x) > TOL


@pytest.mark.parametrize("c", [768, 1024])
def test_wide_tiles_address_the_jax_weights(c):
    """Product j's tile (column block nb, panel kp) holds at row n, logical
    chunk J stored at chunk J ^ (n % 8), weight (64 kp + k, 256 nb + n) of
    the product's (in, out) weight (bf16 tiles 256 columns wide at these
    widths): proj_in, block 1's q | k | v (k and v blocks), w1's interleaved
    h and gate columns (128 units a tile), w2 and proj_out, read straight
    from the JAX-layout parameters."""
    p = _params(c, 7)
    flat = t_motion.weight_blocks_wide(p)
    assert flat.numel() == 22 * c * c and flat.dtype == torch.bfloat16
    offsets = np.cumsum([0, 1, 3, 1, 3, 1, 8, 4]) * c * c  # products' starts, in C² elements

    bn = t_motion.wide_bn(c)
    assert bn == 256

    def stored(prod, k_in, n_out, k_dim):
        nb, n = divmod(n_out, bn)
        kp, k = divmod(k_in, 64)
        tile = offsets[prod] + (nb * (k_dim // 64) + kp) * bn * 64
        return flat[tile + n * 64 + (((k // 8) ^ (n % 8)) * 8) + k % 8]

    bf = lambda v: v.to(torch.bfloat16)  # noqa: E731
    gen = np.random.default_rng(c)
    for _ in range(200):
        k_in, n_out = int(gen.integers(c)), int(gen.integers(c))
        assert stored(0, k_in, n_out, c) == bf(p["w_in"][k_in, n_out])
        assert stored(1, k_in, c + n_out, c) == bf(p["wk"][0, k_in, n_out])
        assert stored(1, k_in, 2 * c + n_out, c) == bf(p["wv"][0, k_in, n_out])
        assert stored(4, k_in, n_out, c) == bf(p["wo"][1, k_in, n_out])
        j = int(gen.integers(4 * c))  # hidden unit j: h column 256 (j // 128) + j % 128, gate + 128
        assert stored(5, k_in, 256 * (j // 128) + j % 128, c) == bf(p["w1"][k_in, j])
        assert stored(5, k_in, 256 * (j // 128) + 128 + j % 128, c) == bf(p["w1"][k_in, 4 * c + j])
        assert stored(6, j, n_out, 4 * c) == bf(p["w2"][j, n_out])
        assert stored(7, k_in, n_out, c) == bf(p["w_out"][k_in, n_out])


# -- the domain plan: other heads, attention blocks, ff_mult and widths --------

def _params_cfg(c, blocks, ff, seed):
    """Seeded raw parameters of a module of ``blocks`` attention blocks and
    ``ff``·C hidden units (fp32; the weights ~ N(0, 1/fan_in))."""
    rng = np.random.default_rng(seed)
    n = lambda *s, std=1.0: torch.from_numpy((rng.standard_normal(s) * std).astype(np.float32))  # noqa: E731
    return dict(gn_scale=1 + n(c, std=0.1), gn_bias=n(c, std=0.1), w_in=n(c, c, std=c**-0.5),
                b_in=n(c, std=0.1), ln_scale=1 + n(blocks + 1, c, std=0.1),
                ln_bias=n(blocks + 1, c, std=0.1), wq=n(blocks, c, c, std=c**-0.5),
                wk=n(blocks, c, c, std=c**-0.5), wv=n(blocks, c, c, std=c**-0.5),
                wo=n(blocks, c, c, std=c**-0.5), bo=n(blocks, c, std=0.1),
                w1=n(c, 2 * ff * c, std=c**-0.5), b1=n(2 * ff * c, std=0.1),
                w2=n(ff * c, c, std=(ff * c) ** -0.5), b2=n(c, std=0.1),
                w_out=n(c, c, std=c**-0.5), b_out=n(c, std=0.1))


# (C, heads, blocks, ff_mult, T, S): JAX's KV-cache test config (4 heads, one
# block) at C = 64; 16 heads of 6 in three blocks at ff_mult 2 (hidden 192:
# three 64-unit tiles) with T = 12 in 16 rows; C = 40 at 8 heads of 5 (one
# ragged 40-input panel, one ragged 40-column block, hidden 160 padded to 192;
# GroupNorm in 8 groups: 32 do not divide 40)
DOMAIN = ((64, 4, 1, 4, 32, 5), (96, 16, 3, 2, 12, 13), (40, 8, 2, 4, 20, 9))
DOMAIN_TOL = 1e-3  # fp32 plan against the Pallas kernel, relative to max|plain - x|


@functools.lru_cache(maxsize=None)
def _domain_case(c, heads, blocks, ff, t, s, dtype):
    cfg = TCfg(num_heads=heads, num_attention_blocks=blocks, ff_mult=ff,
               norm_num_groups=math.gcd(32, c))
    p = _params_cfg(c, blocks, ff, c + heads + blocks)
    x = torch.from_numpy(np.random.default_rng(c + t).standard_normal((1, t, s, c))
                         .astype(np.float32)).to(dtype)
    return cfg, p, x, emulate_wide(x, p, cfg, heads)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", DOMAIN, ids=[f"C{c}-h{h}-b{b}-ff{f}" for c, h, b, f, _, _ in DOMAIN])
def test_domain_plan_matches_plain(case, dtype):
    cfg, p, x, got = _domain_case(*case, dtype)
    want = t_motion.motion_module_plain(x, p, cfg, case[1])
    tol = TOL if dtype == torch.bfloat16 else 1e-5
    assert _rel(got, want, x) <= tol


@pytest.mark.parametrize("case", DOMAIN, ids=[f"C{c}-h{h}-b{b}-ff{f}" for c, h, b, f, _, _ in DOMAIN])
def test_domain_plan_matches_pallas_kernel(case):
    """fp32 inputs, the JAX kernel at the module's heads, blocks and
    ff_mult, within rtol 1e-3 of max|Pallas - x|."""
    c, heads, blocks, ff, t, s = case
    cfg, p, x, got = _domain_case(*case, torch.float32)
    want = fused_motion_module(jnp.asarray(x.numpy()), {k: jnp.asarray(v.numpy()) for k, v in p.items()},
                               heads=heads, interpret=True,
                               cfg=JCfg(num_heads=heads, num_attention_blocks=blocks, ff_mult=ff,
                                        norm_num_groups=math.gcd(32, c)))
    assert _rel(got, torch.from_numpy(np.array(want, np.float32)), x) <= DOMAIN_TOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mutant,case", [("eight_heads", DOMAIN[0]), ("eight_heads", DOMAIN[1]),
                                         ("last_block_dropped", DOMAIN[0]),
                                         ("last_block_dropped", DOMAIN[1])])
def test_wrong_domain_plans_miss_plain(mutant, case, dtype):
    """A chain that attends with 8 heads whatever the config says, and one
    that drops the last attention block, each miss the plain version by more
    than the bf16 tolerance (fp32: by more than 1e-3)."""
    cfg, p, x, _ = _domain_case(*case, dtype)
    want = t_motion.motion_module_plain(x, p, cfg, case[1])
    tol = TOL if dtype == torch.bfloat16 else DOMAIN_TOL
    assert _rel(emulate_wide(x, p, cfg, case[1], mutant=mutant), want, x) > tol


def test_domain_tiles_pad_to_whole_tiles():
    """At C = 40 and ff_mult 4 every product's tiles cover ⌈K/64⌉ panels and
    ⌈N/BN⌉ column blocks (BN = 128 up to N = 128, else 256), zero past K
    and N; w1's hidden units run to F = 256 (160 real: 192 rounded up to a
    whole 128-unit half of the 256-column GEGLU tile) with zero h and gate
    columns past 160, as b1's; w2's rows past 160 are zero."""
    c = 40
    p = _params_cfg(c, 2, 4, 3)
    assert t_motion.wide_hidden(p) == 256
    tiles = Tiles(t_motion.weight_blocks_wide(p))
    w_in = tiles.next(c, c)
    assert w_in.shape == (1, 1, 128, 64)
    logical = w_in[0, 0]  # (out n, in k)
    assert torch.equal(logical[:c, :c], p["w_in"].t().to(torch.bfloat16).float())
    assert not logical[c:].any() and not logical[:, c:].any()
    for _ in range(2):
        tiles.next(c, 3 * c), tiles.next(c, c)
    w1 = tiles.next(c, 2 * 256)  # (2, 1, 256, 64): per 128 units, h then gate columns
    assert w1.shape == (2, 1, 256, 64)
    h_cols = w1[:, 0, :128].reshape(256, 64)[:, :c]
    g_cols = w1[:, 0, 128:].reshape(256, 64)[:, :c]
    bf = lambda v: v.to(torch.bfloat16).float()  # noqa: E731
    assert torch.equal(h_cols[:160], bf(p["w1"][:, :160].t()))
    assert torch.equal(g_cols[:160], bf(p["w1"][:, 160:].t()))
    assert not h_cols[160:].any() and not g_cols[160:].any()
    w2 = tiles.next(256, c)
    assert w2.shape == (1, 4, 128, 64)
    rows = w2[0].permute(1, 0, 2).reshape(128, 256)  # (out n, in k)
    assert torch.equal(rows[:c, :160], bf(p["w2"].t())) and not rows[:, 160:].any()
    tiles.next(c, c)
    assert tiles.off == tiles.flat.numel()
    b1 = t_motion.wide_b1(p)
    assert torch.equal(b1, torch.cat([p["b1"][:160], torch.zeros(96), p["b1"][160:],
                                      torch.zeros(96)]))
