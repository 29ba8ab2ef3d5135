"""The plan of Kernel A's wide forward (``csrc/flash_attention_wide.cu``, D ≡
64 (mod 128), D ≥ 320), emulated in torch on the CPU, against the JAX
flash kernels run as the JAX package's tests run them (Pallas interpret
mode, ``spatial_flash_attention``: the whole-row kernel at n 300 and 1370,
the blocked 512-key kernels at 2443): 64-query CTAs each keeping one slice
of at most 192 output columns, S summed over the D / 64 column panels of
every 64-key tile, the online softmax (exact, or the no-max ``fast``), the
zero-filled ragged last key tile masked, P rounded to the input dtype per
tile and 1/l deferred.  Three wrong plans must each miss: the last output
slice dropped, S summed over the first three panels only, the pad keys
counted.  Also ``FlashAttentionFn``'s gradients at D = 320 (the plain
backward: the JAX VJP there is the dense einsum backward) against JAX's."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from video_depth_anything_torch.ops import flash_attention as t_flash
from video_depth_anything_tpu.ops.pallas_attention import spatial_flash_attention
from tests.test_torch_flash_tiling import FWD_TOL, _qkv
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROWS = 64  # queries a CTA, keys a tile
PANEL = t_flash.WIDE_PANEL
SLICE = t_flash.WIDE_SLICE


def tiled_wide(q, k, v, scale, fast=False, mask=True, panels_in_s=None, drop_last_slice=False):
    """The wide kernel's plan on ``(B, N, H, D)`` inputs; the keywords make
    the wrong plans: ``mask=False`` counts the zero-filled pad keys,
    ``panels_in_s`` sums S over that many panels only, ``drop_last_slice``
    leaves the last slice's columns unwritten (zero)."""
    b, n, h, d = q.shape
    n_pad = -(-n // ROWS) * ROWS
    # (B, N, H, D) → (B, H, N_pad, D) fp32, zero rows past N (as the copies fill them)
    qp, kp, vp = (F.pad(x.float(), (0, 0, 0, 0, 0, n_pad - n)).permute(0, 2, 1, 3)
                  for x in (q, k, v))
    sl2 = scale * t_flash.LOG2E
    panels = range(0, d, PANEL)[:panels_in_s]
    out = torch.zeros(b, h, n_pad, d)
    starts = list(range(0, d, SLICE))
    if drop_last_slice:
        starts = starts[:-1]
    # CTAs of one query block and of one slice are independent: every
    # query row at once, each over the same key tiles in the kernel's order
    for c0 in starts:
        c1 = min(d, c0 + SLICE)
        m = torch.full((b, h, n_pad), 0.0 if fast else -math.inf)
        l = torch.zeros(b, h, n_pad)
        acc = torch.zeros(b, h, n_pad, c1 - c0)
        for j in range(0, n_pad, ROWS):
            kj = kp[:, :, j:j + ROWS]
            s = sum(qp[..., c:c + PANEL] @ kj[..., c:c + PANEL].transpose(-1, -2)
                    for c in panels) * sl2
            if mask and n - j < ROWS:  # the ragged last tile only
                s[..., n - j:] = -math.inf
            if not fast:
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp2(m - m_new)
                acc, l, m = acc * alpha[..., None], l * alpha, m_new
            p = torch.exp2(s - m[..., None])
            l = l + p.sum(-1)
            acc = acc + p.to(q.dtype).float() @ vp[:, :, j:j + ROWS, c0:c1]
        out[..., c0:c1] = acc / l[..., None]
    return out[:, :, :n].permute(0, 2, 1, 3).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _case(n, h, fast, d=320):
    """Inputs and the JAX kernels' output (interpret mode), traced once a
    shape for every test that reads them."""
    q, k, v, _ = _qkv(n + h + fast + d, 1, n, h, d=d)
    want = np.asarray(spatial_flash_attention(*(jnp.asarray(x) for x in (q, k, v)), d**-0.5,
                                              fast_softmax=fast, interpret=True))
    return q, k, v, want


CASES = [(n, h, fast) for n in (300, 1370, 2443) for h in (1, 2) for fast in (False, True)]


@pytest.mark.parametrize("n,h,fast", CASES)
def test_wide_tiling_at_d320_matches_jax_kernels(n, h, fast):
    """D = 320: two slices (192 and 128 columns), five panels; 64-key
    tiles, the last ragged at all three n (20, 38 and 53 pad keys)."""
    q, k, v, want = _case(n, h, fast)
    got = tiled_wide(*map(torch.from_numpy, (q, k, v)), 320**-0.5, fast=fast)
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


def test_wide_tiling_at_d448_matches_jax_kernels():
    """D = 448: slices of 192, 192 and 64 columns over seven panels."""
    q, k, v, want = _case(300, 2, False, d=448)
    got = tiled_wide(*map(torch.from_numpy, (q, k, v)), 448**-0.5)
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


@pytest.mark.parametrize("wrong", [dict(drop_last_slice=True), dict(panels_in_s=3),
                                   dict(mask=False)],
                         ids=["last_slice_dropped", "three_panels_only", "unmasked_zero_pad"])
@pytest.mark.parametrize("n,h", [(300, 1), (1370, 2)])
def test_wrong_wide_plans_miss_the_jax_kernels(wrong, n, h):
    """Each wrong plan misses JAX's output by more than FWD_TOL, relative to
    max|want|, where the right plan is within it.  The default inputs'
    scores (q, k ~ N(0, 0.5²)) keep every row near-uniform, so the pad keys
    take their share of each row's sum."""
    q, k, v, want = _case(n, h, False)
    inputs = (*map(torch.from_numpy, (q, k, v)), 320**-0.5)
    scale = float(np.abs(want).max())
    right = float(np.abs(tiled_wide(*inputs).numpy() - want).max()) / scale
    miss = float(np.abs(tiled_wide(*inputs, **wrong).numpy() - want).max()) / scale
    assert right <= FWD_TOL["rtol"] < miss


def test_chip_smoke_wide_mutants_are_the_wrong_plans():
    """chip_smoke.wide_mutant_errors, which phase wide holds the card's
    kernel against, measures the same three wrong plans: each within 5 %
    of the emulated plan's distance from the plain version (the pad-key
    mutant on the flat inputs)."""
    b, n, h, d = 1, 300, 2, 320
    qkv = chip_smoke.attention_inputs((b, n, h * d), torch.Generator().manual_seed(3), "cpu")
    q, k, v = (x.float().reshape(b, n, h, d) for x in qkv.split(h * d, dim=-1))
    qf = chip_smoke.flat_inputs(q)
    plain = t_flash.flash_attention_plain
    scale = d**-0.5
    got = chip_smoke.wide_mutant_errors(plain, q, k, v, qf, scale)
    want, want_flat = plain(q, k, v, scale), plain(qf, k, v, scale)
    emulated = {
        "last_slice_dropped": chip_smoke.rel_err(tiled_wide(q, k, v, scale, drop_last_slice=True),
                                                 want),
        "three_panels_only": chip_smoke.rel_err(tiled_wide(q, k, v, scale, panels_in_s=3), want),
        "unmasked_zero_pad": chip_smoke.rel_err(tiled_wide(qf, k, v, scale, mask=False),
                                                want_flat),
    }
    assert chip_smoke.rel_err(tiled_wide(q, k, v, scale), want) <= 1e-5
    for name, err in emulated.items():
        assert err > chip_smoke.F32_TOL
        assert abs(got[name] - err) <= 0.05 * err, name


def test_wide_flops_count_the_plan():
    """S once for each 192-column slice, P·V once: 1.5× the dense 4·N²·D at
    D = 320, 2× at 448, 6× at 1984 (11 slices)."""
    for d, ratio in ((320, 1.5), (448, 2.0), (1984, 6.0)):
        assert t_flash.wide_flops(2, 300, 3, d) == ratio * 4.0 * 2 * 3 * 300**2 * d


def test_flash_attention_fn_gradients_at_d320_match_jax_vjp():
    """``FlashAttentionFn`` at D = 320 in fp32 (the forward's plain version,
    the plain backward: ``bwd_gate`` is false there) against the VJP of
    JAX's ``spatial_flash_attention`` (``flash_attention_bhnd``'s dense
    einsum backward), on a ragged n."""
    b, n, h, d = 1, 300, 2, 320
    q, k, v, g = _qkv(7, b, n, h, qk_std=1.6, d=d)
    assert t_flash.flash_gate(q.shape) and not t_flash.bwd_gate(q.shape)
    out, vjp = jax.vjp(lambda *x: spatial_flash_attention(*x, d**-0.5, interpret=True),
                       *(jnp.asarray(x) for x in (q, k, v)))
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = t_flash.FlashAttentionFn.apply(tq, tk, tv, d**-0.5, False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **FWD_TOL)
    got.backward(torch.from_numpy(g))
    for a, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(a.numpy(), w, rtol=1e-3, atol=1e-4)
