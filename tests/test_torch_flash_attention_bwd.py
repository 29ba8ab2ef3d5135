"""Kernel A's backward: ``flash_attention_bwd_plain`` and
``FlashAttentionFn`` on the CPU against the JAX package's Pallas backward
(``flash_attention_native(..., bwd_impl="pallas")`` in interpret mode,
``jax.vjp``), and ``chip_smoke.py``'s check of the backward kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from video_depth_anything_torch.ops import flash_attention as t_flash
from video_depth_anything_tpu.ops.pallas_attention import flash_attention_native
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# fp32: the Pallas kernel rounds nothing in fp32 but sums in another order
# and uses its polynomial exp2 (tests/test_pallas_kernels.py's forward bound
# is 2e-3); the gradients sum N products more.
FP32_TOL = dict(rtol=1e-3, atol=1e-4)
# bf16: the Pallas kernel also rounds q·scale·log2(e) to bf16 before the
# scores, the plain version does not; 3e-2 of max|want| per gradient.
BF16_TOL = 3e-2


def _case(seed, b, n, h):
    rng = np.random.RandomState(seed)
    d = 64
    q, k = (rng.randn(b, n, h, d).astype(np.float32) * 1.6 for _ in range(2))
    v, g = (rng.randn(b, n, h, d).astype(np.float32) for _ in range(2))
    return q, k, v, g


def _jax_vjp(q, k, v, g, dtype):
    b, n, h, d = q.shape
    flat = lambda x: jnp.asarray(x.reshape(b, n, h * d), dtype)  # noqa: E731
    out, vjp = jax.vjp(lambda q_, k_, v_: flash_attention_native(
        q_, k_, v_, scale=d**-0.5, n_valid=n, num_heads=h, bwd_impl="pallas", interpret=True),
        flat(q), flat(k), flat(v))
    grads = vjp(flat(g))
    to_np = lambda x: np.array(x.astype(jnp.float32)).reshape(b, n, h, d)  # noqa: E731
    return to_np(out), [to_np(x) for x in grads]


@pytest.mark.parametrize("n,h", [(300, 2), (384, 2), (300, 6)])
def test_plain_backward_matches_pallas_backward(n, h):
    q, k, v, g = _case(n + h, 1, n, h)
    out, want = _jax_vjp(q, k, v, g, jnp.float32)
    tq, tk, tv, tg, to = map(torch.from_numpy, (q, k, v, g, out))
    got = t_flash.flash_attention_bwd_plain(tq, tk, tv, to, tg, 64**-0.5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, **FP32_TOL)


@pytest.mark.parametrize("n,h", [(384, 6)])
def test_function_gradients_on_cpu_match_pallas_backward(n, h):
    """FlashAttentionFn through strided views of one qkv tensor, as the
    ViT calls it: the qkv gradient."""
    q, k, v, g = _case(7, 2, n, h)
    _, want = _jax_vjp(q, k, v, g, jnp.float32)
    b, d = 2, 64
    qkv = torch.from_numpy(np.concatenate([x.reshape(b, n, h * d) for x in (q, k, v)], -1))
    qkv.requires_grad_()
    tq, tk, tv = (x.view(b, n, h, d) for x in qkv.split(h * d, dim=-1))
    out = t_flash.FlashAttentionFn.apply(tq, tk, tv, d**-0.5)
    (got,) = torch.autograd.grad(out, qkv, torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.concatenate(
        [x.reshape(b, n, h * d) for x in want], -1), **FP32_TOL)


def test_bf16_plain_backward_within_bound_of_pallas_backward():
    q, k, v, g = _case(3, 1, 300, 2)
    out, want = _jax_vjp(q, k, v, g, jnp.bfloat16)
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16)  # noqa: E731
    got = t_flash.flash_attention_bwd_plain(bf(q), bf(k), bf(v), bf(out), bf(g), 64**-0.5)
    for a, b in zip(got, want):
        assert chip_smoke.rel_err(a, torch.from_numpy(b)) <= BF16_TOL


@pytest.mark.parametrize("n", [362, 1370])  # the CLI default and a 518² frame
def test_smoke_check_separates_right_from_wrong(n):
    """chip_smoke.py's check of the backward kernel on its inputs: the
    Pallas backward, a right implementation with its own bf16 rounding
    points, is within BWD_TOL of the plain version; Δ = 0 and a dropped
    last query tile in the dK/dV loop are not."""
    b, h, d = 1, 2, 64
    gen = torch.Generator().manual_seed(n)
    qkv = chip_smoke.attention_inputs((b, n, h * d), gen, "cpu")
    q, k, v = (x.reshape(b, n, h, d) for x in qkv.split(h * d, dim=-1))
    g = torch.randn(b, n, h, d, generator=gen).to(torch.bfloat16)
    o = t_flash.flash_attention_plain(q, k, v, d**-0.5)
    want = t_flash.flash_attention_bwd_plain(q, k, v, o, g, d**-0.5)
    np_ = lambda x: x.float().numpy()  # noqa: E731
    _, jax_grads = _jax_vjp(np_(q), np_(k), np_(v), np_(g), jnp.bfloat16)
    assert chip_smoke.bwd_rel_err([torch.from_numpy(x) for x in jax_grads], want) \
        <= chip_smoke.BWD_TOL
    mutants = chip_smoke.bwd_mutant_errors(q, k, v, o, g, d**-0.5)
    assert min(mutants.values()) > chip_smoke.BWD_TOL, mutants


@pytest.mark.parametrize("shape,expected", [
    ((8, 362, 6, 64), True),      # vits at the CLI default, 266²
    ((32, 1370, 16, 64), True),   # vitl at 518²
    ((32, 2443, 6, 64), False),   # > 2048 padded keys: the dense backward in JAX
    ((2, 1370, 5, 64), False),    # odd head count: the blocked kernel in JAX
    ((2, 200, 6, 64), False),     # under 256 tokens: no flash kernel at all
])
def test_bwd_gate(shape, expected):
    assert t_flash.bwd_gate(shape) is expected


def test_raw_launches_refuse_to_drop_gradients():
    q = torch.zeros(1, 300, 2, 64, requires_grad=True)
    with pytest.raises(RuntimeError, match="autograd"):
        t_flash.flash_attention(q, q, q, 0.125)
    with torch.no_grad():
        t_flash.flash_attention(q, q, q, 0.125)
