"""The plan of the fp32 Kernel C (``csrc/motion_module_f32.cu``), emulated in
torch on the CPU (``tests/test_torch_fp32.py``: ``emulate_motion_f32``),
against the JAX Pallas motion kernel run in interpret mode on fp32 inputs
and against the port's plain version, with the wrong plans it must tell
apart.

The plan: 64-row CTAs (whole locations, a ragged last CTA whose rows past
S are zero and never stored); every product in 3xTF32 (activations split
as the kernel splits them in registers, weights as ``weight_blocks_f32``
split them on the host), each warpgroup's weight blocks read in the order
its ring delivers them (``MotionRing``); GroupNorm applied at the load,
each LayerNorm (+ APE) once a row, in place.  Held
here: the plan within 1e-5 of the JAX kernel and of the plain version at
every width, T = 8, 16 and 32 (the layout bit for bit at every width:
``test_torch_fp32.py``); the tiles' swizzle and input order; five wrong
plans missing by more than chip_smoke.py's fp32 tolerance (1e-4):
one pass (hi·hi), two passes (no lo·hi), a truncating split, a ring block
read for the wrong product, and LayerNorm statistics of the wrong row
block; the kernel's Plan against ``F32_PLAN`` and its shared memory;
``chip_smoke.motion_split_plain`` and ``bench_fp32``'s Kernel C bounds."""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_fp32 import FP32_TOL, _motion_params, emulate_motion_f32, rel
from video_depth_anything_torch import bench_fp32
from video_depth_anything_torch.config import MotionModuleConfig as TCfg
from video_depth_anything_torch.ops import motion_module as t_motion
from video_depth_anything_tpu.config import MotionModuleConfig as JCfg
from video_depth_anything_tpu.ops.pallas_motion import fused_motion_module
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MUTANT_TOL = chip_smoke.F32_TOL  # a wrong plan must miss by more than the card's tolerance
SOURCE = Path(t_motion.__file__).resolve().parent.parent / "csrc" / "motion_module_f32.cu"


@functools.lru_cache(maxsize=None)
def _case(c: int, t: int, s: int):
    """Seeded fp32 x ``(1, T, S, C)``, raw parameters and the plain output."""
    p = _motion_params(c, c + t)
    x = torch.from_numpy(np.random.default_rng(c * 3 + t).standard_normal((1, t, s, c))
                         .astype(np.float32))
    return x, p, t_motion.motion_module_plain(x, p, TCfg(), 8)


@pytest.mark.parametrize("c,t,s", [(64, 16, 9), (64, 32, 3), (128, 8, 19), (128, 32, 5),
                                   (192, 16, 5), (256, 8, 10), (256, 32, 3), (384, 16, 5),
                                   (64, 12, 9), (128, 20, 5), (256, 24, 3)])
def test_motion_f32_plan_matches_plain(c, t, s):
    """Every width at T = 8, 16 and 32, two or three CTAs, the last ragged;
    T = 12, 20 and 24 padded to Tp = 16, 32 and 32 rows a location."""
    x, p, want = _case(c, t, s)
    assert rel(emulate_motion_f32(x, p, TCfg(), 8), want, x) <= FP32_TOL


@pytest.mark.parametrize("c,t,s", [(128, 32, 3), (192, 16, 5)])
def test_motion_f32_plan_matches_jax_kernel_at_wide_chunks(c, t, s):
    """The JAX kernel in interpret mode on fp32 inputs at C = 128 (two
    chunks of 64 channels, two warpgroups) and 192 (four chunks of 48,
    padded to 64; three warpgroups)."""
    x, p, _ = _case(c, t, s)
    want = np.asarray(fused_motion_module(jnp.asarray(x.numpy()),
                                          {k: jnp.asarray(v.numpy()) for k, v in p.items()},
                                          heads=8, cfg=JCfg(), interpret=True))
    assert rel(emulate_motion_f32(x, p, TCfg(), 8), want, x) <= FP32_TOL


@pytest.mark.parametrize("mutant", ["one_pass", "two_pass", "truncating_split", "wrong_block",
                                    "stats_wrong_block"])
@pytest.mark.parametrize("c,t,s", [(64, 8, 10), (256, 32, 3)])
def test_motion_f32_wrong_plans_miss(c, t, s, mutant):
    """Each wrong plan misses the plain version by more than the card's 1e-4
    where the plan itself is within 1e-5 (two CTAs: the statistics of the
    other CTA's rows differ)."""
    x, p, want = _case(c, t, s)
    assert rel(emulate_motion_f32(x, p, TCfg(), 8), want, x) <= FP32_TOL
    assert rel(emulate_motion_f32(x, p, TCfg(), 8, mutant=mutant), want, x) > MUTANT_TOL


def test_f32_tiles_swizzle_and_input_order():
    """A tile's row n holds output column n; its 16-byte chunk j sits at
    chunk j ^ (n % 8); within each 16 inputs the order is 0 2 4 .. 14 | 1 3
    .. 15 by k8 step: a thread's float4 of columns 4c .. 4c + 3 is its tf32
    A fragment slots (c, c + 4) of both steps."""
    w = torch.arange(64 * 64, dtype=torch.float32).reshape(64, 64) * 2.0**-6  # hi + lo exact
    tiles = t_motion.f32_tiles(w)
    assert tiles.shape == (1, 2, 2, 64, 32)
    hi = tiles[0, 1, 0] + tiles[0, 1, 1]
    for n in (0, 5, 13, 63):
        for logical in (0, 1, 4, 7, 8, 12, 17, 31):
            j, e = divmod(logical, 4)
            stored = hi[n, 4 * (j ^ (n % 8)) + e]
            step, slot = divmod(logical % 16, 8)
            want_k = 32 + 16 * (logical // 16) + 4 * (slot % 4) + 2 * step + slot // 4
            assert stored == w[want_k, n]


def _plan_of_source() -> dict:
    text = SOURCE.read_text()
    plans = re.findall(r"struct Plan<(\d+)> \{\s*static constexpr int NSPLIT = (\d+), NST = "
                       r"(\d+), MINB = (\d+);", text)
    return {int(c): tuple(map(int, rest)) for c, *rest in plans}


def test_f32_plan_matches_the_kernel_source():
    """``F32_PLAN`` (the host layout's warpgroups) is the kernel's Plan; at
    every width the output blocks split evenly, at most three a warpgroup,
    the feed-forward's hidden chunks into whole steps, and the shared
    memory (rings of 16 KB stages, y with rows of C + 16 floats, the
    64 x 208 scratch, barriers) fits the 227 KB opt-in limit
    at the Plan's CTAs a SM."""
    src = _plan_of_source()
    assert set(src) == set(t_motion.F32_PLAN) == {64, 128, 192, 256, 384}
    for c, (ns, nst, minb) in src.items():
        assert t_motion.F32_PLAN[c] == (ns, nst)
        assert c % (64 * ns) == 0 and c // 64 // ns <= 3 and (4 * c) % (64 * ns) == 0
        smem = 4 * (ns * nst * 2 * 64 * 32 + 64 * (c + 16) + 64 * 208) + 16 * ns * nst + 1024
        assert nst >= 2 and smem * minb <= 232448 + (minb - 1) * 1024


def test_chip_smoke_motion_split_mutants_miss():
    """``chip_smoke.motion_split_plain``, the card's wrong 3xTF32 Kernel C
    plans, on the CPU: all three passes within 1e-5 of the plain fp32
    version, two passes and a truncating split each missing by more than
    1e-4."""
    x, p, want = _case(64, 8, 10)
    got = chip_smoke.motion_split_plain(x, p, TCfg(), 8, "three_pass")
    base = float((want - x).abs().max())
    assert float((got - want).abs().max()) / base <= FP32_TOL
    for mutant in ("two_pass", "truncating_split"):
        wrong = chip_smoke.motion_split_plain(x, p, TCfg(), 8, mutant)
        assert float((wrong - want).abs().max()) / base > MUTANT_TOL


def test_bench_fp32_motion_bounds():
    """bench_fp32's Kernel C bounds at the shapes PERF.md quotes (3xTF32 at
    495 TFLOP/s, FFMA at 67) and the L2 weight bytes of a call (the FFMA
    design's 32 rows a CTA over 22 C² floats; 64 rows over the hi and lo
    blocks)."""
    assert bench_fp32.motion_bounds(1, 32, 5476, 256) == pytest.approx((3.1320, 7.7131), abs=1e-4)
    assert bench_fp32.motion_bounds(1, 32, 2442, 384) == pytest.approx((3.1193, 7.6819), abs=1e-4)
    assert bench_fp32.l2_weight_bytes(1, 32, 5476, 256, 22 * 256 * 256 * 4, 32) == pytest.approx(
        31.581e9, rel=1e-4)
    blocks = 4096 * 4 * t_motion.f32_weight_blocks(256)
    assert bench_fp32.l2_weight_bytes(1, 32, 5476, 256, blocks, 64) == 2738 * blocks
