"""The plans of the fp32 Kernels A and B (``csrc/flash_attention_f32.cu``,
``csrc/temporal_attention_f32.cu``), emulated in torch on the CPU
(``tests/test_torch_fp32.py``), against the JAX Pallas kernels run in
interpret mode on fp32 inputs, with the wrong plans each must tell apart.

Kernel A splits every fp32 operand for the tensor cores: hi = rna(x), the
TF32 round to nearest with ties away from zero (``cvt.rna.tf32.f32``),
and lo = rna(x − hi); a product is lo·hi + hi·lo + hi·hi.  Held here: the
split bit for bit; the plan within 1e-5 of JAX, exact and fast; and four
wrong plans that miss by more than chip_smoke.py's fp32 tolerance (1e-4):
one pass (hi·hi), two passes (no lo·hi), a truncating split (the raw
operand as hi, read truncated by the tensor cores), and TMA's zero-filled
pad keys left unmasked.  Kernel B: the persistent walk over two-stage
rings, and the three wrong plans a ring invites (a stage read before its
copy lands, stale key rows unmasked, v's rows past T not zeroed)."""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_fp32 import (
    FP32_TOL,
    _jax_flash,
    emulate_flash_f32,
    emulate_temporal_f32,
    rel,
    split_tf32,
    temporal_f32_unit,
    tf32,
)
from video_depth_anything_torch import bench_fp32
from video_depth_anything_torch.ops import flash_attention as t_flash
from video_depth_anything_torch.ops import temporal_attention as t_temporal
from video_depth_anything_tpu.ops.pallas_temporal import temporal_attention_window
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MUTANT_TOL = chip_smoke.F32_TOL  # a wrong plan must miss by more than the card's tolerance


def rel_nan(got, want) -> float:
    """``rel``, with a NaN anywhere in ``got`` as an infinite miss."""
    return math.inf if torch.isnan(torch.as_tensor(got)).any() else rel(got, want)


def _bits(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _rna_reference(x: float) -> float:
    """TF32's round to nearest, ties away from zero, by exact arithmetic:
    m · 2^(e − 10) with the integer m nearest to |x| / 2^(e − 10), halves
    away from zero (x normal, and far from fp32's largest values)."""
    if x == 0.0:
        return x
    e = math.frexp(abs(x))[1] - 1  # 2^e <= |x| < 2^(e + 1)
    ulp = 2.0 ** (e - 10)
    m = math.floor(abs(x) / ulp + 0.5)
    return math.copysign(m * ulp, x)


@pytest.mark.parametrize("kind", ["normal", "ties", "wide", "tiny"])
def test_tf32_split_bit_for_bit(kind):
    """hi has at most 10 mantissa bits and is x rounded to nearest with
    ties away from zero, as ``cvt.rna`` and ``chip_smoke.tf32_round`` give
    it; lo = rna(x − hi) with x − hi exact; hi + lo is x within 2^-22 of
    |x|."""
    rng = np.random.default_rng(len(kind))
    if kind == "ties":  # exactly halfway between two TF32 values, both signs
        base = _bits(rng.standard_normal(4096)) & np.uint32(0xFFFFE000)
        x = (base | np.uint32(0x1000)).view(np.float32)
    elif kind == "wide":
        x = (rng.standard_normal(4096) * 10.0 ** rng.uniform(-30, 30, 4096)).astype(np.float32)
    elif kind == "tiny":  # small probabilities whose lo stays a normal fp32 value
        x = (rng.choice([-1.0, 1.0], 4096) * 2.0 ** rng.uniform(-100, -80, 4096)).astype(np.float32)
    else:
        x = rng.standard_normal(4096).astype(np.float32)
    t = torch.from_numpy(x)
    hi, lo = split_tf32(t)
    assert not (_bits(hi.numpy()) & np.uint32(0x1FFF)).any()  # 10 mantissa bits
    assert not (_bits(lo.numpy()) & np.uint32(0x1FFF)).any()
    want = np.array([_rna_reference(float(v)) for v in x], np.float32)
    np.testing.assert_array_equal(_bits(hi.numpy()), _bits(want))
    np.testing.assert_array_equal(_bits(hi.numpy()), _bits(chip_smoke.tf32_round(t).numpy()))
    np.testing.assert_array_equal(_bits(lo.numpy()), _bits(tf32(t - hi).numpy()))
    assert torch.equal((t.double() - hi.double()).float().double(), t.double() - hi.double())
    err = ((hi.double() + lo.double()) - t.double()).abs()
    assert bool((err <= t.double().abs() * 2.0**-22).all())
    if kind == "ties":  # halves go away from zero: |hi| > |x|
        assert bool((hi.abs() > t.abs()).all())


@functools.lru_cache(maxsize=None)
def _flash_case(d: int, n: int, fast: bool):
    """Seeded fp32 (1, n, 2, d) q, k, v and the JAX kernel's output (one
    interpret call a case, shared by the tests below)."""
    rng = np.random.RandomState(d + n)
    q, k, v = (rng.randn(1, n, 2, d).astype(np.float32) for _ in range(3))
    return q, k, v, _jax_flash(q, k, v, fast=fast)


@pytest.mark.parametrize("d", [64, 192])
def test_flash_3xtf32_fast_plan_matches_jax_kernel(d):
    """The FAST plan (m = 0, no rescale) in 3xTF32 against the JAX fast
    kernel at n = 300 (ragged last key tile at both widths)."""
    q, k, v, want = _flash_case(d, 300, True)
    got = emulate_flash_f32(*map(torch.from_numpy, (q, k, v)), d**-0.5, fast=True)
    assert rel(got, want) <= FP32_TOL


@pytest.mark.parametrize("mutant", ["one_pass", "two_pass", "truncating_split", "unmasked_pad"])
@pytest.mark.parametrize("d", [64, 192])
def test_flash_3xtf32_wrong_plans_miss(d, mutant):
    """Each wrong plan misses the JAX kernel by more than the card's 1e-4
    where the plan itself is within 1e-5 (n = 300: 20 pad keys)."""
    q, k, v, want = _flash_case(d, 300, False)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    assert rel(emulate_flash_f32(tq, tk, tv, d**-0.5), want) <= FP32_TOL
    assert rel(emulate_flash_f32(tq, tk, tv, d**-0.5, mutant=mutant), want) > MUTANT_TOL


@functools.lru_cache(maxsize=None)
def _temporal_case(d: int, t: int, s: int):
    rng = np.random.RandomState(d * 7 + t + s)
    q, k, v = (rng.randn(1, t, s, 8 * d).astype(np.float32) for _ in range(3))
    want = np.asarray(temporal_attention_window(*(jnp.asarray(x) for x in (q, k, v)), heads=8,
                                                scale=d**-0.5, interpret=True))
    return q, k, v, want


@pytest.mark.parametrize("mutant", ["stale_stage", "unmasked_keys", "v_rows_not_zeroed"])
@pytest.mark.parametrize("d", [8, 128])
def test_temporal_f32_ring_mutants_are_caught(d, mutant):
    """T = 17, S = 11 (ragged at C = 64's two locations a tile), three CTAs
    walking two-stage rings: the plan within 1e-5 of JAX, each wrong ring
    missing by more than 1e-4 (NaN stale rows turn into NaN outputs)."""
    q, k, v, want = _temporal_case(d, 17, 11)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    assert rel(emulate_temporal_f32(tq, tk, tv, 8, d**-0.5), want) <= FP32_TOL
    got = emulate_temporal_f32(tq, tk, tv, 8, d**-0.5, mutant=mutant)
    assert rel_nan(got, want) > MUTANT_TOL


@pytest.mark.parametrize("c", [64, 128, 192, 256, 384, 1024])
def test_temporal_f32_units_fill_four_warps(c):
    """Every shipped width's 128-channel tile holds at least four units (of
    QF query frames) for four consumer warps, a lane's QF · KL / 32 frames
    × DC columns are 32 accumulators, and a pass leaves each of the KL
    lanes of a row an even number of columns (8-byte stores)."""
    d = c // 8
    locs, group = t_temporal.tile_plan(c, 8, 4)
    qf, kl, dc = temporal_f32_unit(d)
    assert locs * group * (32 // qf) >= 4
    assert qf * kl // 32 * dc == 32 and d % dc == 0 and dc // kl % 2 == 0


def test_flash_f32_tma_geometry_of_the_qkv_views():
    """The fp32 kernel reads k and v through 4-byte tensor maps of the fused
    qkv projection's views: rows of 3·H·D floats, 16-byte multiples."""
    qkv = torch.zeros(2, 300, 3 * 6 * 64)
    k = qkv[..., 6 * 64:2 * 6 * 64].view(2, 300, 6, 64)
    dims, strides = t_flash.tma_geometry(k)
    assert dims == (64, 6, 300, 2) and strides == (256, 3 * 6 * 64 * 4, 300 * 3 * 6 * 64 * 4)
    with pytest.raises(ValueError, match="16 bytes"):
        t_flash.tma_geometry(torch.zeros(2, 300, 1, 67)[..., :64])


def test_bench_fp32_bounds_and_card():
    """bench_fp32's bounds (3xTF32 at 495 TFLOP/s, FFMA at 67, bytes at
    3.35 TB/s) at the shapes PERF.md quotes, and no run without a card."""
    assert bench_fp32.flash_bounds(32, 1370, 6, 64) == pytest.approx((0.5591, 1.3769), abs=1e-4)
    assert bench_fp32.flash_bounds(32, 2443, 6, 64)[0] == pytest.approx(1.7779, abs=1e-4)
    assert bench_fp32.temporal_bound(1, 32, 1369, 1024) == pytest.approx(0.2143, abs=1e-4)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            bench_fp32.main([])


@pytest.mark.parametrize("fast", [False, True])
def test_chip_smoke_split_mutants_miss(fast):
    """``chip_smoke.tf32_split_plain``, the card's wrong 3xTF32 kernels, on
    the CPU: all three passes within 1e-5 of the plain fp32 version, two
    passes and a truncating split each missing by more than 1e-4 (the card
    checks that its tolerance tells them from the kernel)."""
    qkv = chip_smoke.f32_inputs((1, 300, 2 * 64), torch.Generator().manual_seed(3), "cpu")
    q, k, v = (t.view(1, 300, 2, 64) for t in qkv.split(2 * 64, dim=-1))
    want = t_flash.flash_attention_plain(q, k, v, 0.125, fast=fast)
    got = chip_smoke.tf32_split_plain(q, k, v, 0.125, fast, "three_pass")
    assert chip_smoke.rel_err(got, want) <= FP32_TOL
    for mutant in ("two_pass", "truncating_split"):
        wrong = chip_smoke.tf32_split_plain(q, k, v, 0.125, fast, mutant)
        assert chip_smoke.rel_err(wrong, want) > MUTANT_TOL
