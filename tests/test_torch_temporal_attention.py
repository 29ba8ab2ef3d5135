"""Kernel B's plain version against the JAX temporal kernel (Pallas
interpret mode on the CPU) at every head width of its domain (vits, vitb
and, under ``--attn_impl pallas``, vitl), and its gate under ``auto`` and
``pallas``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from video_depth_anything_torch.ops import temporal_attention as t_temporal
from video_depth_anything_tpu.ops.pallas_temporal import temporal_attention_window
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# The JAX package's own bound for this kernel (tests/test_pallas_kernels.py):
# the Pallas kernel rounds q·scale to the input dtype before the products.
TOL = dict(rtol=2e-3, atol=2e-3)


# d = 8 (vits m2/m3), 24 (m0), 16 (vitb m2/m3); under pallas 32 (vitl m2),
# 48 (vits m1, vitb m0), 128 (vitl m0/m1)
@pytest.mark.parametrize("c,s", [(64, 20), (192, 13), (128, 17), (256, 11), (384, 7),
                                 (1024, 5)])
def test_plain_matches_pallas_kernel(c, s):
    heads, t = 8, 32
    rng = np.random.RandomState(c)
    q, k, v = (rng.randn(2, t, s, c).astype(np.float32) * f for f in (0.5, 0.5, 1.0))
    scale = (c // heads) ** -0.5
    want = np.asarray(temporal_attention_window(
        *(jnp.asarray(x) for x in (q, k, v)), heads=heads, scale=scale, interpret=True))
    got = t_temporal.temporal_attention_plain(*map(torch.from_numpy, (q, k, v)), heads, scale)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_wrapper_on_cpu_tensors_is_the_plain_version():
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, 8, 5, 64).astype(np.float32)) for _ in range(3))
    torch.testing.assert_close(t_temporal.temporal_attention(q, k, v, 8, 0.3),
                               t_temporal.temporal_attention_plain(q, k, v, 8, 0.3),
                               rtol=0, atol=0)


@pytest.mark.parametrize("shape,expected", [
    ((1, 32, 1369, 192), True),   # vits m0 at 518²: d = 24
    ((1, 32, 1369, 64), True),    # vits m2 at 518²: d = 8
    ((1, 32, 361, 384), False),   # vits m1: d = 48 stays on the plain path
    ((1, 4, 1369, 64), False),    # fewer than 8 frames
    ((1, 32, 1369, 128), True),   # vitb m2 at 518²: d = 16
    ((1, 32, 1369, 384), False),  # vitb m0 at 518²: d = 48 stays on the plain path
])
def test_temporal_gate(shape, expected):
    assert t_temporal.temporal_gate(shape, 8) is expected


@pytest.mark.parametrize("shape,expected", [
    ((1, 32, 1369, 192), True),    # vits m0: d = 24
    ((1, 32, 361, 384), True),     # vits m1: d = 48
    ((1, 32, 1369, 384), True),    # vitb m0: d = 48
    ((1, 32, 361, 768), False),    # vitb m1: d = 96, outside the lane packing
    ((1, 32, 1369, 1024), True),   # vitl m0: d = 128
    ((1, 32, 1369, 256), True),    # vitl m2: d = 32
    ((1, 4, 1369, 256), False),    # fewer than 8 frames
])
def test_temporal_gate_under_pallas(shape, expected, monkeypatch):
    """``auto=False`` (``--attn_impl pallas``) drops the d ≤ 24 rule and
    keeps the lane-packing rules: the same answer as JAX
    ``try_temporal_attention(..., auto=False)`` with its kernel replaced by
    a tag and a device that says TPU."""
    import jax

    from video_depth_anything_tpu.ops import pallas_temporal

    class _TPU:
        platform = "tpu"

    monkeypatch.setattr(pallas_temporal, "temporal_attention_window", lambda *a, **k: "kernel")
    monkeypatch.setattr(jax, "devices", lambda *a: [_TPU()])
    x = np.empty(shape, np.uint8)
    jax_says = pallas_temporal.try_temporal_attention(x, x, x, heads=8, scale=1.0, auto=False)
    assert (jax_says == "kernel") is expected
    assert t_temporal.temporal_gate(shape, 8, auto=False) is expected


@pytest.mark.parametrize("c", [256, 384, 1024])
def test_wrapper_domain_on_cpu(c):
    """The wrapper takes the new widths (d = 32, 48, 128) on CPU tensors
    as its plain version, and ``tile_plan`` gives each whole heads."""
    rng = np.random.RandomState(c)
    q, k, v = (torch.from_numpy(rng.randn(1, 17, 3, c).astype(np.float32)) for _ in range(3))
    torch.testing.assert_close(t_temporal.temporal_attention(q, k, v, 8, 0.2),
                               t_temporal.temporal_attention_plain(q, k, v, 8, 0.2),
                               rtol=0, atol=0)
    locs, group = t_temporal.tile_plan(c, 8)
    assert 8 % group == 0 and locs >= 1 and group * (c // 8) <= max(c // 8, 256)


@pytest.mark.parametrize("c", [64, 192, 128])  # d = 8 (vits m2), 24 (m0), 16 (vitb m2)
def test_smoke_check_separates_right_from_wrong(c):
    """chip_smoke.py's check of Kernel B on its inputs: the JAX Pallas
    kernel, a right implementation with its own bf16 rounding points, is
    within the tolerance of the plain version; uniform attention over the
    frames and a dropped last frame are not."""
    heads, t, s = 8, 32, 24
    qkv = chip_smoke.attention_inputs((1, t, s, c), torch.Generator().manual_seed(c), "cpu")
    q, k, v = (x.contiguous() for x in qkv.split(c, dim=-1))
    scale = (c // heads) ** -0.5
    want = t_temporal.temporal_attention_plain(q, k, v, heads, scale)
    jax_out = temporal_attention_window(
        *(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)), heads=heads,
        scale=scale, interpret=True)
    got = torch.from_numpy(np.asarray(jax_out, np.float32))
    assert chip_smoke.rel_err(got, want) <= chip_smoke.ATTN_TOL
    plain = lambda q_, k_, v_, sc: t_temporal.temporal_attention_plain(q_, k_, v_, heads, sc)  # noqa: E731
    mutants = chip_smoke.mutant_errors(plain, q, k, v, scale, axis=1, tile=1)
    assert min(mutants.values()) > chip_smoke.ATTN_TOL, mutants
