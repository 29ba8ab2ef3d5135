"""The tiling of Kernel B's Hopper kernel (``csrc/temporal_attention.cu``),
emulated in torch on the CPU, against the JAX Pallas temporal kernel run as
the JAX package's tests run it (interpret mode) and against the port's
plain version: the walk over tiles of (``tile_plan``'s adjacent locations ×
whole-head group), each tile a 32-frame stage whose rows past T hold
garbage (NaN here) except v's, which the kernel zeroes once; units of
(location, head, 16 or 32 query rows); S = Q Kᵀ in k steps of 16 and a last
step of 8; keys at or past T masked to −inf; the exp2 softmax of a row (the
kernel's quad-lane reduction) with P rounded to the inputs' dtype (bf16 on
the card) before P·V, which runs in 16-key steps (one when T ≤ 16); the out
written over the unit's q rows, and only rows before T and locations
before S stored.  Also the two wrong tilings that ``chip_smoke.py``
checks for (the last location tile never stored, zero keys unmasked).

The bf16 run-time-d kernel (``csrc/temporal_attention_any.cu``: every width
the gate admits off the six above; the fp32 one has its own plan, held in
``tests/test_torch_temporal_any_f32_tiling.py``) walks the same ``tile_plan`` tiles, its
shared rows fp32 and only the T loaded frames (no stale rows, nothing
padded), a unit a (location, head, query frame) over 1–8 lanes that split
its columns: scores over the T keys in fp32 (the lanes' partial sums
added), the exp2 softmax, P rounded to the inputs' dtype, P·V in fp32, the
out over the unit's q row.  ``any_kernel`` emulates it, held against the
Pallas kernel in interpret mode and the plain version at d = 5 (8 heads),
96 (4 heads) and 3 (16 heads), with a wrong kernel that reads each head
over the next instantiated width's columns."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from video_depth_anything_torch.ops import temporal_attention as t_temporal
from video_depth_anything_tpu.ops.pallas_temporal import temporal_attention_window
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# The JAX package's own bound for this kernel (tests/test_pallas_kernels.py).
TOL = dict(rtol=2e-3, atol=2e-3)
HEADS = 8
LOG2E = 1.0 / math.log(2.0)


def tiled_kernel(q, k, v, heads, scale, plan=None, mutant=None):
    """``(B, T, S, C)`` → ``(B, T, S, C)`` in the kernel's tiling and
    rounding points (the inputs' dtype).  ``mutant``:
    ``"last_location_tile_dropped"`` or ``"unmasked_zero_keys"``."""
    b, t, s, c = q.shape
    d = c // heads
    dt = q.dtype
    locs, group = plan or t_temporal.tile_plan(c, heads)
    cg = group * d
    rows_per_unit = 16 if d >= 48 else 32
    sblocks, hgroups = -(-s // locs), heads // group
    sl2 = scale * LOG2E
    out = torch.zeros(b, t, s, c, dtype=dt)
    for tile in range(b * sblocks * hgroups):  # head group fastest
        hg, r = tile % hgroups, tile // hgroups
        sb, bi = r % sblocks, r // sblocks
        s0, c0 = sb * locs, hg * cg
        lv = min(locs, s - s0)
        if mutant == "last_location_tile_dropped" and s0 + locs >= s:
            continue
        stage = torch.full((3, 32, locs, cg), math.nan)  # never loaded: stale in the ring
        stage[2, t:] = 0.0  # v's rows past T: zeroed once
        if mutant == "unmasked_zero_keys":  # a ring zero-filled past T, keys left unmasked
            stage[1, t:] = 0.0
        for x, src in enumerate((q, k, v)):
            stage[x, :t, :lv] = src[bi, :, s0:s0 + lv, c0:c0 + cg].float()
        for l in range(lv):
            for h in range(group):
                qh, kh, vh = (stage[x, :, l, h * d:(h + 1) * d] for x in range(3))
                for row0 in range(0, 32, rows_per_unit):
                    if row0 >= t:
                        continue
                    rows = slice(row0, row0 + rows_per_unit)
                    sc = torch.zeros(rows_per_unit, 32)
                    for k0 in range(0, d - d % 16, 16):
                        sc += qh[rows, k0:k0 + 16] @ kh[:, k0:k0 + 16].T
                    if d % 16:
                        sc += qh[rows, d - 8:] @ kh[:, d - 8:].T
                    x = sc * sl2
                    if mutant != "unmasked_zero_keys":
                        x[:, t:] = -math.inf
                    p = torch.exp2(x - x.amax(-1, keepdim=True))
                    p = (p * (1.0 / p.sum(-1, keepdim=True))).to(dt).float()
                    acc = torch.zeros(rows_per_unit, d)
                    for kk in range(2 if t > 16 else 1):
                        acc += p[:, kk * 16:(kk + 1) * 16] @ vh[kk * 16:(kk + 1) * 16]
                    stage[0, rows, l, h * d:(h + 1) * d] = acc.to(dt).float()
        out[bi, :, s0:s0 + lv, c0:c0 + cg] = stage[0, :t, :lv].to(dt)
    return out


def _qkv(seed, b, t, s, c):
    rng = np.random.RandomState(seed)
    q, k = (rng.randn(b, t, s, c).astype(np.float32) * 0.5 for _ in range(2))
    return q, k, rng.randn(b, t, s, c).astype(np.float32)


@pytest.mark.parametrize("t", [8, 17, 32])
@pytest.mark.parametrize("d", [8, 16, 24, 32, 48, 128])
def test_tiling_matches_jax_kernel_and_plain(d, t):
    """fp32 inputs (as the JAX package's kernel tests): S = 7 leaves a ragged
    last location tile at C = 64 (4 locations a tile) and 128 (2)."""
    c, s = HEADS * d, 7
    scale = d**-0.5
    q, k, v = _qkv(d * 100 + t, 2, t, s, c)
    want = np.asarray(temporal_attention_window(*(jnp.asarray(x) for x in (q, k, v)),
                                                heads=HEADS, scale=scale, interpret=True))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = tiled_kernel(tq, tk, tv, HEADS, scale).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    plain = t_temporal.temporal_attention_plain(tq, tk, tv, HEADS, scale).numpy()
    np.testing.assert_allclose(got, plain, **TOL)


@pytest.mark.parametrize("d", [8, 16, 24, 32, 48, 128])
def test_tiling_in_bf16_matches_plain(d):
    """bf16 inputs on chip_smoke.py's peaked attention inputs: P and the
    out rounded to bf16 at the plain version's points, within ATTN_TOL of
    max|plain| (they differ in exp2 against exp and in summation order)."""
    c, t, s = HEADS * d, 17, 9
    qkv = chip_smoke.attention_inputs((1, t, s, c), torch.Generator().manual_seed(d), "cpu")
    q, k, v = (x.contiguous() for x in qkv.split(c, dim=-1))
    scale = d**-0.5
    want = t_temporal.temporal_attention_plain(q, k, v, HEADS, scale)
    got = tiled_kernel(q, k, v, HEADS, scale)
    assert got.dtype == torch.bfloat16
    assert chip_smoke.rel_err(got, want) <= chip_smoke.ATTN_TOL


@pytest.mark.parametrize("mutant", ["last_location_tile_dropped", "unmasked_zero_keys"])
def test_wrong_tilings_are_caught(mutant):
    """The mutants of chip_smoke.temporal_mutant_errors, made by the
    emulation itself, miss the plain version by more than ATTN_TOL, as the
    smoke run's own estimates of them do."""
    d, t, s = 48, 17, 101
    c = HEADS * d
    qkv = chip_smoke.attention_inputs((1, t, s, c), torch.Generator().manual_seed(1), "cpu")
    q, k, v = (x.contiguous() for x in qkv.split(c, dim=-1))
    scale = d**-0.5
    want = t_temporal.temporal_attention_plain(q, k, v, HEADS, scale)
    got = tiled_kernel(q, k, v, HEADS, scale, mutant=mutant)
    assert chip_smoke.rel_err(got, want) > chip_smoke.ATTN_TOL
    plain = lambda q_, k_, v_, sc: t_temporal.temporal_attention_plain(q_, k_, v_, HEADS, sc)  # noqa: E731
    smoke = chip_smoke.temporal_mutant_errors(plain, q, k, v, scale,
                                              t_temporal.tile_plan(c, HEADS)[0])
    assert smoke[mutant] > chip_smoke.ATTN_TOL


@pytest.mark.parametrize("c,plan", [(64, (4, 8)), (128, (2, 8)), (192, (1, 8)), (256, (1, 8)),
                                    (384, (1, 4)), (1024, (1, 2))])
def test_tile_plan(c, plan):
    """Every head a tile up to C = 256 with 512-byte runs where C divides
    256, else head groups of at most 256 channels; the kernel's shared
    rows of locs × group × d + 8 bf16 are an odd number of 16-byte chunks
    (conflict-free ldmatrix over 8 frames)."""
    assert t_temporal.tile_plan(c, HEADS) == plan
    locs, group = plan
    assert (locs * group * (c // HEADS) + 8) * 2 // 16 % 2 == 1


def test_other_plans_compute_the_same():
    """The tiling's geometry is free: a smaller head group and more
    locations give the same output as ``tile_plan``'s."""
    q, k, v = map(torch.from_numpy, _qkv(3, 1, 32, 11, 384))
    want = tiled_kernel(q, k, v, HEADS, 48**-0.5)
    for plan in ((2, 4), (3, 2), (1, 8)):
        torch.testing.assert_close(tiled_kernel(q, k, v, HEADS, 48**-0.5, plan=plan), want,
                                   rtol=1e-6, atol=1e-6)


# -- the run-time-d kernel -------------------------------------------------------

def any_kernel(q, k, v, heads, scale, mutant=None):
    """``(B, T, S, C)`` → ``(B, T, S, C)`` in the run-time-d kernel's tiling
    and rounding points.  ``mutant``: ``"last_location_tile_dropped"``, or
    ``"d_rounded_up"`` (each head's scores over the next instantiated
    width's columns of the tile row, from the head's own first column)."""
    b, t, s, c = q.shape
    d = c // heads
    dt = q.dtype
    locs, group = t_temporal.tile_plan(c, heads, q.element_size())
    cg = group * d
    sblocks, hgroups = -(-s // locs), heads // group
    sl2 = scale * LOG2E
    dr = next(w for w in t_temporal._SUPPORTED_D + (c,) if w >= d)
    out = torch.zeros(b, t, s, c, dtype=dt)
    for tile in range(b * sblocks * hgroups):  # head group fastest
        hg, r = tile % hgroups, tile // hgroups
        sb, bi = r % sblocks, r // sblocks
        s0, c0 = sb * locs, hg * cg
        lv = min(locs, s - s0)
        if mutant == "last_location_tile_dropped" and s0 + locs >= s:
            continue
        rows = torch.stack([x[bi, :, s0:s0 + lv, c0:c0 + cg].float() for x in (q, k, v)])
        flat = rows.reshape(3, t, lv * cg)  # the shared rows: T frames, no padding
        o = torch.zeros(t, lv * cg)
        for l in range(lv):
            for h in range(group):
                col = l * cg + h * d
                qc, kc = flat[0, :, col:col + d], flat[1, :, col:col + d]
                if mutant == "d_rounded_up":
                    qc, kc = flat[0, :, col:col + dr], flat[1, :, col:col + dr]
                x = (qc @ kc.T) * sl2  # (query, key): the T loaded keys only
                p = torch.exp2(x - x.amax(-1, keepdim=True))
                p = (p * (1.0 / p.sum(-1, keepdim=True))).to(dt).float()
                o[:, col:col + d] = p @ flat[2, :, col:col + d]
        out[bi, :, s0:s0 + lv, c0:c0 + cg] = o.reshape(t, lv, cg).to(dt)
    return out


def rounded_width_error(q, k, v, heads, scale):
    """chip_smoke's estimate of the rounded-width mutant, relative to
    max|plain|."""
    want = t_temporal.temporal_attention_plain(q, k, v, heads, scale)
    return chip_smoke.rel_err(chip_smoke.rounded_width_plain(q, k, v, heads, scale), want)


# (heads, d, T, S): packed small heads, a wide head without an instantiation,
# and three-channel heads at the fewest frames; S leaves ragged location tiles
ANY_CASES = ((8, 5, 32, 7), (4, 96, 17, 5), (16, 3, 8, 9))


@pytest.mark.parametrize("heads,d,t,s", ANY_CASES)
def test_any_kernel_matches_jax_kernel_and_plain(heads, d, t, s):
    c = heads * d
    assert not t_temporal.instantiated(c, heads)
    assert t_temporal.temporal_gate((2, t, s, c), heads, auto=False)
    scale = d**-0.5
    q, k, v = _qkv(c + t, 2, t, s, c)
    want = np.asarray(temporal_attention_window(*(jnp.asarray(x) for x in (q, k, v)),
                                                heads=heads, scale=scale, interpret=True))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = any_kernel(tq, tk, tv, heads, scale).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * np.abs(want).max())
    plain = t_temporal.temporal_attention_plain(tq, tk, tv, heads, scale).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-3, atol=1e-3 * np.abs(plain).max())


@pytest.mark.parametrize("heads,d,t,s", ANY_CASES)
def test_any_kernel_in_bf16_matches_plain(heads, d, t, s):
    c = heads * d
    qkv = chip_smoke.attention_inputs((1, t, s, c), torch.Generator().manual_seed(d), "cpu")
    q, k, v = (x.contiguous() for x in qkv.split(c, dim=-1))
    scale = d**-0.5
    want = t_temporal.temporal_attention_plain(q, k, v, heads, scale)
    got = any_kernel(q, k, v, heads, scale)
    assert got.dtype == torch.bfloat16
    assert chip_smoke.rel_err(got, want) <= chip_smoke.ATTN_TOL


@pytest.mark.parametrize("mutant", ["d_rounded_up", "last_location_tile_dropped"])
@pytest.mark.parametrize("heads,d,t,s", ANY_CASES)
def test_wrong_any_kernels_are_caught(heads, d, t, s, mutant):
    """Each head scored over the next instantiated width's columns (d = 5
    as 8, 96 as 128, 3 as 8), and the last location tile never stored,
    miss the plain version by more than ATTN_TOL; so do chip_smoke's own
    estimates of them."""
    c = heads * d
    qkv = chip_smoke.attention_inputs((1, t, s, c), torch.Generator().manual_seed(1), "cpu")
    q, k, v = (x.contiguous() for x in qkv.split(c, dim=-1))
    scale = d**-0.5
    want = t_temporal.temporal_attention_plain(q, k, v, heads, scale)
    assert chip_smoke.rel_err(any_kernel(q, k, v, heads, scale, mutant=mutant), want) > \
        chip_smoke.ATTN_TOL
    if mutant == "d_rounded_up":
        assert rounded_width_error(q, k, v, heads, scale) > chip_smoke.ATTN_TOL
    else:
        plain = lambda q_, k_, v_, sc: t_temporal.temporal_attention_plain(q_, k_, v_, heads, sc)  # noqa: E731
        locs = t_temporal.tile_plan(c, heads)[0]
        assert chip_smoke.temporal_mutant_errors(plain, q, k, v, scale, locs)[mutant] > \
            chip_smoke.ATTN_TOL


@pytest.mark.parametrize("c,heads,dtype", [(40, 8, torch.bfloat16), (384, 4, torch.bfloat16),
                                           (48, 16, torch.float32), (512, 1, torch.bfloat16),
                                           (2048, 16, torch.float32)])
def test_any_row_stride_is_conflict_free_and_fits(c, heads, dtype):
    """The run-time-d kernel's row stride: the tile's channels, then V
    more only where ld / V would be even (V the widest read that divides
    d), so 32 query rows' V-wide reads hit distinct banks; three 32-frame
    stages of it fit in shared memory."""
    d = c // heads
    vec = 4 if d % 4 == 0 else 2 if d % 2 == 0 else 1
    itemsize = 2 if dtype == torch.bfloat16 else 4
    locs, group = t_temporal.tile_plan(c, heads, itemsize)
    ld = t_temporal.any_row_stride(c, heads, itemsize)
    assert ld % vec == 0 and (ld // vec) % 2 == 1 and ld - locs * group * d in (0, vec)
    banks = {(r * ld // vec) % (32 // vec) for r in range(32 // vec)}
    assert len(banks) == 32 // vec
    assert t_temporal.kernel_takes((1, 32, 1, c), heads, dtype)
