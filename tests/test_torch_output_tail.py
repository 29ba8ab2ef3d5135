"""The output tail's plain version against the JAX package's
``xla_output_tail`` (the oracle of its fused Pallas tail) on the same
seeded inputs, the port's copy of the JAX gate, the tail kernel's host-side
tables, and ``chip_smoke.py``'s check of the kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from video_depth_anything_torch.config import get_model_config
from video_depth_anything_torch.ops import output_tail as t_tail
from video_depth_anything_tpu.ops import pallas_output_stack as j_tail
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# C = 128 (vitl's head width); the second case is the head's 8:14 ratio.
SHAPES = [((1, 8, 12, 128), (14, 21)), ((2, 32, 32, 128), (56, 56))]
FP32_TOL = dict(rtol=1e-3, atol=2e-4)  # the port's fp32 bound (docs/PARITY.md:12)
BF16_ULP = 2.0**-8  # bf16: 2.5 ulps of max|ref|, the JAX tail test's bound


def _case(shape, seed):
    """x ~ N(0, 1) and output_conv2's weights at the JAX tail test's scales,
    in the port's (torch) layout."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    w1 = (rng.standard_normal((32, c, 3, 3)) * 0.1).astype(np.float32)
    b1 = (rng.standard_normal(32) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((1, 32, 1, 1)) * 0.3).astype(np.float32)
    b2 = (rng.standard_normal(1) * 0.1).astype(np.float32)
    return x, w1, b1, w2, b2


def _jax_tail(x, w1, b1, w2, b2, out_hw, dtype):
    """``xla_output_tail`` on the same values: weights to HWIO."""
    k1, k2 = w1.transpose(2, 3, 1, 0), w2.transpose(2, 3, 1, 0)
    out = j_tail.xla_output_tail(jnp.asarray(x, dtype), jnp.asarray(k1), jnp.asarray(b1),
                                 jnp.asarray(k2), jnp.asarray(b2), *out_hw)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("shape,out_hw", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_xla_output_tail(shape, out_hw, dtype):
    x, w1, b1, w2, b2 = _case(shape, seed=sum(shape))
    tdt = getattr(torch, dtype)
    got = t_tail.output_tail_plain(torch.from_numpy(x).to(tdt), *map(torch.from_numpy, (w1, b1, w2, b2)),
                                   *out_hw).float().numpy()
    want = _jax_tail(x, w1, b1, w2, b2, out_hw, getattr(jnp, dtype))
    assert got.shape == want.shape == shape[:1] + out_hw + (1,)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **FP32_TOL)
    else:
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, atol=2.5 * BF16_ULP)


def test_plain_in_chunks_matches_xla_output_tail(monkeypatch):
    """Frames whose resized maps pass the element limit (cut here to two
    frames' worth) run in chunks of frames, to the same values."""
    x, w1, b1, w2, b2 = _case((5, 8, 12, 128), seed=5)
    monkeypatch.setattr(t_tail.resize, "_MAX_ELEMENTS", 2 * 14 * 21 * 128)
    got = t_tail.output_tail_plain(*map(torch.from_numpy, (x, w1, b1, w2, b2)), 14, 21)
    np.testing.assert_allclose(got.numpy(), _jax_tail(x, w1, b1, w2, b2, (14, 21), "float32"),
                               **FP32_TOL)


def test_wrapper_on_cpu_tensors_is_the_plain_version():
    args = [torch.from_numpy(a) for a in _case((1, 8, 12, 128), seed=1)]
    args[0] = args[0].to(torch.bfloat16)
    before = t_tail.output_tail.launches
    got = t_tail.output_tail(*args, 14, 21)
    assert t_tail.output_tail.launches == before
    torch.testing.assert_close(got, t_tail.output_tail_plain(*args, 14, 21), rtol=0, atol=0)


@pytest.mark.parametrize("shape,out_hw", SHAPES)
def test_smoke_check_separates_right_from_wrong(shape, out_hw):
    """chip_smoke.py's check of the tail kernel on its inputs: the JAX XLA
    chain, a right implementation with its own summation order, is within
    the tolerance of the plain version; align_corners=False taps and a
    centre-only conv3×3 are not."""
    x, w1, b1, w2, b2 = chip_smoke.tail_inputs(*shape[:3], torch.Generator().manual_seed(3),
                                               "cpu")
    want = t_tail.output_tail_plain(x, w1, b1, w2, b2, *out_hw)
    jax_out = _jax_tail(x.float().numpy(), *(t.numpy() for t in (w1, b1, w2, b2)), out_hw,
                        jnp.bfloat16)
    assert chip_smoke.rel_err(torch.from_numpy(jax_out), want) <= chip_smoke.TAIL_TOL
    mutants = chip_smoke.tail_mutant_errors(x, w1, b1, w2, b2, *out_hw)
    assert min(mutants.values()) > chip_smoke.TAIL_TOL, mutants


@pytest.mark.parametrize("n,h,w,c,oh,ow", [
    (32, 296, 296, 128, 518, 518),   # vitl 518²: admitted
    (32, 296, 528, 128, 518, 924),   # vitl 518×924: over the budget
    (32, 296, 296, 32, 518, 518),    # vits width, 4-frame packing
    (30, 24, 20, 64, 42, 35),        # vitb width, frames not divisible by 2
    (1, 8, 12, 128, 14, 21),
])
def test_vmem_estimate_is_the_jax_one(n, h, w, c, oh, ow):
    assert t_tail._vmem_estimate(n, h, w, c, oh, ow) == j_tail._vmem_estimate(n, h, w, c, oh, ow)


@pytest.mark.parametrize("encoder,shape,out_hw,dtype,expected", [
    ("vitl", (32, 296, 296, 128), (518, 518), torch.bfloat16, True),
    ("vitl", (32, 296, 528, 128), (518, 924), torch.bfloat16, False),
    ("vitl", (32, 296, 296, 128), (518, 518), torch.float32, False),
    ("vitl", (8, 184, 184, 128), (322, 322), torch.bfloat16, True),
    ("vits", (32, 296, 296, 32), (518, 518), torch.bfloat16, False),   # packed "pre" plan
    ("vitb", (32, 296, 296, 64), (518, 518), torch.bfloat16, False),   # packed "post" plan
])
def test_gate(encoder, shape, out_hw, dtype, expected):
    assert t_tail.output_tail_gate(get_model_config(encoder), shape, dtype, *out_hw) is expected


@pytest.mark.parametrize("in_size,out_size", [(296, 518), (528, 924), (8, 14), (5, 1), (7, 7)])
def test_tap_tables_are_the_jax_ones(in_size, out_size):
    """The kernel's fp32 taps equal ``_vertical_tables`` of the TPU kernel.
    Where the fp32 source index lands a hair past the last row (lo == hi),
    the port puts weight 1 on that row and the TPU table splits it into
    1 - frac and frac on the same row: the same value."""
    idx, wts = t_tail._taps(in_size, out_size, torch.device("cpu"))
    lo, hi, w0, w1 = j_tail._vertical_tables(in_size, out_size)
    np.testing.assert_array_equal(idx.numpy(), np.concatenate([lo, hi]))
    got_w0, got_w1 = wts.numpy().reshape(2, out_size)
    split = lo != hi
    np.testing.assert_array_equal(got_w0[split], w0[split])
    np.testing.assert_array_equal(got_w1[split], w1[split])
    np.testing.assert_allclose((got_w0 + got_w1)[~split], (w0 + w1)[~split], rtol=0, atol=1e-6)


def test_conv_weight_fragments_follow_the_kernels_addressing():
    """csrc/output_tail.cu reads w1's B operand for k16 step q = tap·C/16 +
    kk from tile q // 4 at 32-byte step q % 4 (``conv_weight_tiles``): row
    n of tile T, logical 16-byte chunk J (stored at J ^ (n % 8)) must hold
    w1[n, c, dy, dx] for K index 64T + 8J + e = (3dy + dx)·C + c."""
    c = 64
    w1 = torch.arange(32 * c * 9, dtype=torch.float32).reshape(32, c, 3, 3) % 251
    tiles = t_tail.conv_weight_tiles(w1)
    assert tiles.shape == (9 * c // 64, 32, 64)
    for t in range(9 * c // 64):
        for n in range(32):
            for chunk in range(8):
                got = tiles[t, n, 8 * (chunk ^ (n % 8)):8 * (chunk ^ (n % 8)) + 8]
                want = []
                for e in range(8):
                    k = 64 * t + 8 * chunk + e
                    want.append(float(w1[n, k % c, k // (3 * c), k // c % 3]))
                assert got.float().tolist() == want
