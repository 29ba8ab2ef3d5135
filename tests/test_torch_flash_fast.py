"""Kernel A's ``:fast`` (no-max) plain version, its D = 192 and odd-head
coverage against the JAX flash kernels (Pallas interpret mode on the CPU),
and the ``attn_impl`` parsing against the JAX ``multi_head_attention``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from video_depth_anything_torch.ops import attention as t_attention
from video_depth_anything_torch.ops import flash_attention as t_flash
from video_depth_anything_tpu.ops import attention as j_attention
from video_depth_anything_tpu.ops.attention import _xla_attention
from video_depth_anything_tpu.ops.pallas_attention import (
    flash_attention_native,
    spatial_flash_attention,
)
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# The JAX package's own bound for its kernels (tests/test_pallas_kernels.py):
# the Pallas kernels round q·scale·log2(e) to the input dtype and use a
# polynomial exp2.
TOL = dict(rtol=2e-3, atol=2e-3)


def _qkv(seed, b, n, h, d=64, qk_std=0.5):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, n, h, d).astype(np.float32) * qk_std
    k = rng.randn(b, n, h, d).astype(np.float32) * qk_std
    v = rng.randn(b, n, h, d).astype(np.float32)
    return q, k, v


def _plain(q, k, v, fast):
    d = q.shape[-1]
    return t_flash.flash_attention_plain(*map(torch.from_numpy, (q, k, v)), d**-0.5,
                                         fast=fast).numpy()


@pytest.mark.parametrize("n", [300, 2500])  # whole-row kernel; 2500: _flash_kernel_fast
def test_fast_plain_matches_blocked_fast_kernel(n):
    b, h, d = 1, 2, 64
    q, k, v = _qkv(n + 7, b, n, h, d)
    want = np.asarray(spatial_flash_attention(*(jnp.asarray(x) for x in (q, k, v)), d**-0.5,
                                              fast_softmax=True, interpret=True))
    np.testing.assert_allclose(_plain(q, k, v, fast=True), want, **TOL)


def test_fast_plain_matches_native_fast_kernel():
    """The fast branch of ``_flash_kernel_native`` (N = 700, H = 4)."""
    b, n, h, d = 2, 700, 4, 64
    q, k, v = _qkv(11, b, n, h, d)
    want = np.asarray(flash_attention_native(
        *(jnp.asarray(x.reshape(b, n, h * d)) for x in (q, k, v)), scale=d**-0.5, n_valid=n,
        num_heads=h, fast_softmax=True, interpret=True)).reshape(b, n, h, d)
    np.testing.assert_allclose(_plain(q, k, v, fast=True), want, **TOL)


@pytest.mark.parametrize("n,h,d,fast", [
    (300, 3, 64, False),    # odd head count: _flash_kernel_single
    (700, 5, 64, True),     # odd heads, fast branch of _flash_kernel_single
    (300, 2, 192, False),   # D = 192: _flash_kernel_single
    (520, 1, 192, True),    # D = 192, fast
])
def test_single_kernel_domain(n, h, d, fast):
    """Odd H and D = 192 at padded N ≤ 2048 go to ``_flash_kernel_single``
    in the JAX package; the port's plain version (and Kernel A on the card)
    cover them."""
    q, k, v = _qkv(n + h + d, 1, n, h, d)
    want = np.asarray(spatial_flash_attention(*(jnp.asarray(x) for x in (q, k, v)), d**-0.5,
                                              fast_softmax=fast, interpret=True))
    np.testing.assert_allclose(_plain(q, k, v, fast=fast), want, **TOL)
    assert t_flash.flash_gate(q.shape)


def test_fast_large_logits():
    """tests/test_pallas_kernels.py:63-79: scaled scores near ±60 stay
    inside the exp2 domain; the fast plain version stays finite and equals
    the exact attention and the JAX fast kernel."""
    b, n, h, d = 1, 256, 1, 64
    q, k, v = _qkv(5, b, n, h, d, qk_std=4.0)
    got = _plain(q, k, v, fast=True)
    assert np.isfinite(got).all()
    exact = np.asarray(_xla_attention(*(jnp.asarray(x) for x in (q, k, v)), d**-0.5))
    jax_fast = np.asarray(spatial_flash_attention(*(jnp.asarray(x) for x in (q, k, v)), d**-0.5,
                                                  fast_softmax=True, interpret=True))
    np.testing.assert_allclose(got, exact, **TOL)
    np.testing.assert_allclose(got, jax_fast, **TOL)


def test_wrapper_on_cpu_tensors_is_the_plain_version():
    q, k, v = map(torch.from_numpy, _qkv(3, 1, 300, 3, 192))
    before = (t_flash.flash_attention.launches, t_flash.flash_attention.fast_launches)
    torch.testing.assert_close(t_flash.flash_attention(q, k, v, 0.1, fast=True),
                               t_flash.flash_attention_plain(q, k, v, 0.1, fast=True),
                               rtol=0, atol=0)
    assert (t_flash.flash_attention.launches, t_flash.flash_attention.fast_launches) == before


@pytest.mark.parametrize("impl", ["auto", "auto:fast", "xla", "xla:fast", "pallas",
                                  "pallas:fast"])
def test_impl_strings_match_jax(impl):
    """Every impl string the JAX ``multi_head_attention`` takes gives the
    same attention on the CPU (where JAX runs its XLA path and the port its
    plain versions), with and without the flash gate."""
    for b, n, h in ((1, 300, 2), (2, 40, 2)):
        q, k, v = _qkv(n, b, n, h)
        want = np.asarray(j_attention.multi_head_attention(
            *(jnp.asarray(x) for x in (q, k, v)), impl=impl))
        got = t_attention.multi_head_attention(*map(torch.from_numpy, (q, k, v)), impl).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl,device,expected", [
    ("auto", "cuda", ("auto", False)),
    ("auto:fast", "cuda", ("auto", True)),
    ("xla:fast", "cuda", ("xla", True)),
    ("pallas", "cpu", ("pallas", False)),
    ("pallas:fast", "cpu", ("pallas", True)),
])
def test_parse_attn_impl(impl, device, expected):
    assert t_attention.parse_attn_impl(impl, device) == expected


@pytest.mark.parametrize("impl", ["flash", "auto:slow", "fast"])
def test_unknown_impl_strings_raise(impl):
    with pytest.raises(ValueError):
        t_attention.parse_attn_impl(impl, "cpu")


@pytest.mark.parametrize("n,h,d", [(2443, 2, 64), (1370, 3, 64), (1370, 2, 192)])
def test_smoke_check_separates_right_from_wrong_fast(n, h, d):
    """chip_smoke.py's check of the fast variant (and of D = 192, odd H) on
    its peaked inputs: the JAX fast kernel, a right implementation with its
    own rounding points, is within the tolerance of the fast plain version;
    uniform attention and a dropped last key tile are not."""
    qkv = chip_smoke.attention_inputs((1, n, h * d), torch.Generator().manual_seed(n + d), "cpu")
    q, k, v = (x.reshape(1, n, h, d) for x in qkv.split(h * d, dim=-1))
    plain = lambda q_, k_, v_, sc: t_flash.flash_attention_plain(q_, k_, v_, sc, fast=True)  # noqa: E731
    want = plain(q, k, v, d**-0.5)
    jax_out = spatial_flash_attention(
        *(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)), d**-0.5,
        fast_softmax=True, interpret=True)
    got = torch.from_numpy(np.asarray(jax_out, np.float32))
    assert chip_smoke.rel_err(got, want) <= chip_smoke.ATTN_TOL
    mutants = chip_smoke.mutant_errors(plain, q, k, v, d**-0.5, axis=1, tile=64)
    assert min(mutants.values()) > chip_smoke.ATTN_TOL, mutants
