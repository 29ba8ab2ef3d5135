"""Kernel A's plain version against the JAX flash kernels (Pallas interpret
mode on the CPU), and the spatial-attention dispatch of the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from video_depth_anything_torch.ops import attention as t_attention
from video_depth_anything_torch.ops import flash_attention as t_flash
from video_depth_anything_tpu.ops.attention import _xla_attention
from video_depth_anything_tpu.ops.pallas_attention import (
    flash_attention_native,
    spatial_flash_attention,
)
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# Same bound as the JAX package's own kernel tests (tests/test_pallas_kernels.py):
# the Pallas kernels round q·scale·log2(e) to the input dtype and use a
# polynomial exp2.
TOL = dict(rtol=2e-3, atol=2e-3)


def _qkv(seed, b, n, h, d=64):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, n, h, d).astype(np.float32) * 0.5
    k = rng.randn(b, n, h, d).astype(np.float32) * 0.5
    v = rng.randn(b, n, h, d).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("n,h", [(300, 2), (700, 2), (1370, 2)])
def test_plain_matches_native_layout_kernel(n, h):
    b, d = 2, 64
    q, k, v = _qkv(n, b, n, h, d)
    want = np.asarray(flash_attention_native(
        *(jnp.asarray(x.reshape(b, n, h * d)) for x in (q, k, v)),
        scale=d**-0.5, n_valid=n, num_heads=h, interpret=True)).reshape(b, n, h, d)
    got = t_flash.flash_attention_plain(*map(torch.from_numpy, (q, k, v)), d**-0.5).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("n", [300, 2500])  # 2500 > 2048: several 512-key blocks
def test_plain_matches_blocked_kernel(n):
    b, h, d = 1, 2, 64
    q, k, v = _qkv(n + 1, b, n, h, d)
    want = np.asarray(spatial_flash_attention(
        *(jnp.asarray(x) for x in (q, k, v)), d**-0.5, interpret=True))
    got = t_flash.flash_attention_plain(*map(torch.from_numpy, (q, k, v)), d**-0.5).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_wrapper_on_cpu_tensors_is_the_plain_version():
    q, k, v = map(torch.from_numpy, _qkv(3, 1, 300, 2))
    torch.testing.assert_close(t_flash.flash_attention(q, k, v, 0.125),
                               t_flash.flash_attention_plain(q, k, v, 0.125), rtol=0, atol=0)


def test_strided_qkv_views_match_xla_attention():
    """The model hands the kernel views of one fused qkv projection."""
    b, n, h, d = 2, 260, 6, 64
    rng = np.random.RandomState(4)
    qkv = rng.randn(b, n, 3 * h * d).astype(np.float32) * 0.5
    tq, tk, tv = (x.view(b, n, h, d) for x in torch.from_numpy(qkv).split(h * d, dim=-1))
    got = t_attention.multi_head_attention(tq, tk, tv).numpy()
    jq, jk, jv = (jnp.asarray(x).reshape(b, n, h, d) for x in np.split(qkv, 3, axis=-1))
    want = np.asarray(_xla_attention(jq, jk, jv, d**-0.5))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,expected", [
    ((32, 1370, 6, 64), True),    # vits 518²: native-layout kernel in JAX
    ((32, 2443, 6, 64), True),    # vits 518×924: blocked kernel in JAX
    ((2, 26, 6, 64), False),      # fewer than 256 tokens
    ((2, 1370, 4, 128), False),   # d % 128 == 0: no spare lane for the row sum
])
def test_flash_gate(shape, expected):
    assert t_flash.flash_gate(shape) is expected


@pytest.mark.parametrize("n", [1370, 2443])  # vits 518² and 518×924 token counts
def test_smoke_check_separates_right_from_wrong(n):
    """chip_smoke.py's check of Kernel A on its inputs: the JAX blocked
    kernel, a right implementation with its own bf16 rounding points, is
    within the tolerance of the plain version; uniform attention and a
    dropped last key tile are not."""
    b, h, d = 1, 2, 64
    qkv = chip_smoke.attention_inputs((b, n, h * d), torch.Generator().manual_seed(n), "cpu")
    q, k, v = (x.reshape(b, n, h, d) for x in qkv.split(h * d, dim=-1))
    want = t_flash.flash_attention_plain(q, k, v, d**-0.5)
    jax_out = spatial_flash_attention(
        *(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)), d**-0.5,
        interpret=True)
    got = torch.from_numpy(np.asarray(jax_out, np.float32))
    assert chip_smoke.rel_err(got, want) <= chip_smoke.ATTN_TOL
    mutants = chip_smoke.mutant_errors(t_flash.flash_attention_plain, q, k, v, d**-0.5,
                                       axis=1, tile=64)
    assert min(mutants.values()) > chip_smoke.ATTN_TOL, mutants
