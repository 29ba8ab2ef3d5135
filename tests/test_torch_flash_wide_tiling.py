"""The plan of Kernel A's wide forward (``csrc/flash_attention_wide.cu``, D ≡
64 (mod 128), D ≥ 320), emulated in torch on the CPU, against the JAX
flash kernels run as the JAX package's tests run them (Pallas interpret
mode, ``spatial_flash_attention``: the whole-row kernel at n 300 and 1370,
the blocked 512-key kernels at 2443).

The plan: one consumer warpgroup of 64 query rows a CTA, keeping one
320-column slice of O (five 64-column panels; the
last slice starts at D − 320 and stores only the panels the slice before
it left), S computed once a slice over all of D, the online softmax
(exact, or the no-max ``fast``), the zero-filled ragged last key tile
masked, and 1/l deferred.  bf16: 64-key tiles, P rounded to the input
dtype per tile (bf16 on the card; the fp32 inputs here keep it fp32).
fp32: 32-key tiles, every operand split by a pre-pass into hi = rna(x) and
lo = rna(x − hi) (q after its scaling by scale · log2 e), both products in
three TF32 passes (lo·hi + hi·lo + hi·hi), P split in registers, and the
keys of each group of 8 permuted the same way in P and in Vᵀ.  The wrong
plans each must miss: the consumer storing its panels rotated by one, S
summed without the last 64
columns, the pad keys counted, and in fp32 one TF32 pass or Vᵀ's keys left
unpermuted.  Also ``FlashAttentionFn``'s gradients at D = 320 (the plain
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
from tests.test_torch_fp32 import FP32_TOL, rel, split_tf32
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PANEL = t_flash.WIDE_PANEL
SLICE = t_flash.WIDE_SLICE
PLANS = {"bf16": 64, "fp32": 32}  # keys a tile (a CTA is 64 query rows in both)
PERM = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])  # Vᵀ's position j within 8 holds key PERM[j]
MUTANT_TOL = chip_smoke.F32_TOL  # an fp32 wrong plan must miss by more than the card's tolerance


def _tf32_mm(a, b, one_pass=False):
    """``a @ b`` in 3xTF32 (lo·hi + hi·lo + hi·hi), or hi·hi alone."""
    ahi, alo = split_tf32(a)
    bhi, blo = split_tf32(b)
    return ahi @ bhi if one_pass else (alo @ bhi + ahi @ blo) + ahi @ bhi


def tiled_wide(q, k, v, scale, fast=False, plan="bf16", mutant=None):
    """The wide kernel's plan on fp32 ``(B, N, H, D)`` inputs.  ``mutant``
    makes a wrong plan: ``panels_rotated`` (the consumer stores its
    slice's panel t at panel t + 1, mod 5),
    ``panel_dropped_from_s``, ``unmasked_zero_pad``; in fp32 also
    ``one_pass`` and ``v_keys_unpermuted``."""
    b, n, h, d = q.shape
    kt = PLANS[plan]
    f32 = plan == "fp32"
    n_pad = -(-n // kt) * kt
    # (B, N, H, D) → (B, H, N_pad, D), zero rows past N (as TMA fills them)
    qp, kp, vp = (F.pad(x.float(), (0, 0, 0, 0, 0, n_pad - n)).permute(0, 2, 1, 3)
                  for x in (q, k, v))
    sl2 = scale * t_flash.LOG2E
    if f32:  # the pre-pass scales q, so S is in the exp2 domain
        qp, sl2 = qp * sl2, 1.0
    s_cols = d - PANEL if mutant == "panel_dropped_from_s" else d
    one_pass = mutant == "one_pass"
    out = torch.zeros(b, h, n_pad, d)
    for sl in range(-(-d // SLICE)):  # slices are independent CTAs: every query row at once
        c0 = min(sl * SLICE, d - SLICE)
        m = torch.full((b, h, n_pad), 0.0 if fast else -math.inf)
        l = torch.zeros(b, h, n_pad)
        acc = torch.zeros(b, h, n_pad, SLICE)
        for j in range(0, n_pad, kt):
            qs, ks = qp[..., :s_cols], kp[:, :, j:j + kt, :s_cols].transpose(-1, -2)
            s = (_tf32_mm(qs, ks, one_pass) if f32 else qs @ ks) * sl2
            if mutant != "unmasked_zero_pad" and n - j < kt:  # the ragged last tile only
                s[..., n - j:] = -math.inf
            if not fast:
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp2(m - m_new)
                acc, l, m = acc * alpha[..., None], l * alpha, m_new
            p = torch.exp2(s - m[..., None])
            l = l + p.sum(-1)
            vj = vp[:, :, j:j + kt, c0:c0 + SLICE]
            if f32:  # P's positions and Vᵀ's hold the keys of each 8 in PERM's order
                order = (torch.arange(kt) // 8 * 8 + PERM.repeat(kt // 8))
                vj = vj if mutant == "v_keys_unpermuted" else vj[:, :, order]
                acc = acc + _tf32_mm(p[..., order], vj, one_pass)
            else:
                acc = acc + p.to(q.dtype).float() @ vj  # P rounded to the input dtype
        o = acc / l[..., None]
        if mutant == "panels_rotated":
            o = torch.roll(o.unflatten(-1, (SLICE // PANEL, PANEL)), 1, dims=-2).flatten(-2)
        new = max(sl * SLICE, c0)  # the columns this slice stores
        out[..., new:c0 + SLICE] = o[..., new - c0:]
    return out[:, :, :n].permute(0, 2, 1, 3)


@functools.lru_cache(maxsize=None)
def _case(n, h, fast, d=320):
    """Inputs and the JAX kernels' output (interpret mode), traced once a
    shape for every test that reads them."""
    q, k, v, _ = _qkv(n + h + fast + d, 1, n, h, d=d)
    want = np.asarray(spatial_flash_attention(*(jnp.asarray(x) for x in (q, k, v)), d**-0.5,
                                              fast_softmax=fast, interpret=True))
    return q, k, v, want


def _check_plan(got, want, plan):
    """bf16's plan within FWD_TOL, fp32's within FP32_TOL of max|want| (the
    3xTF32 products are fp32-accurate)."""
    if plan == "fp32":
        assert rel(got, want) <= FP32_TOL
    else:
        np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


CASES = [(n, h, fast) for n in (300, 1370, 2443) for h in (1, 2) for fast in (False, True)]


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("n,h,fast", CASES)
def test_wide_tiling_at_d320_matches_jax_kernels(n, h, fast, plan):
    """D = 320: one slice, five panels, S computed once; the last key tile
    ragged at all three n (bf16 64-key tiles: 20, 38 and 53 pad keys; fp32
    32-key tiles: 20, 6 and 21)."""
    q, k, v, want = _case(n, h, fast)
    got = tiled_wide(*map(torch.from_numpy, (q, k, v)), 320**-0.5, fast=fast, plan=plan)
    _check_plan(got, want, plan)


@pytest.mark.parametrize("plan", list(PLANS))
def test_wide_tiling_at_d448_matches_jax_kernels(plan):
    """D = 448: two slices, of panels 0-4 and 2-6 (the second stores 5-6),
    S computed twice."""
    q, k, v, want = _case(300, 2, False, d=448)
    got = tiled_wide(*map(torch.from_numpy, (q, k, v)), 448**-0.5, plan=plan)
    _check_plan(got, want, plan)


BF16_WRONG = ["panels_rotated", "panel_dropped_from_s", "unmasked_zero_pad"]
F32_WRONG = BF16_WRONG + ["one_pass", "v_keys_unpermuted"]


@pytest.mark.parametrize("mutant", BF16_WRONG)
@pytest.mark.parametrize("n,h", [(300, 1), (1370, 2)])
def test_wrong_wide_plans_miss_the_jax_kernels(mutant, n, h):
    """Each wrong bf16 plan misses JAX's output by more than FWD_TOL,
    relative to max|want|, where the right plan is within it.  The default
    inputs' scores (q, k ~ N(0, 0.5²)) keep every row near-uniform, so the
    pad keys take their share of each row's sum."""
    q, k, v, want = _case(n, h, False)
    inputs = (*map(torch.from_numpy, (q, k, v)), 320**-0.5)
    scale = float(np.abs(want).max())
    right = float(np.abs(tiled_wide(*inputs).numpy() - want).max()) / scale
    miss = float(np.abs(tiled_wide(*inputs, mutant=mutant).numpy() - want).max()) / scale
    assert right <= FWD_TOL["rtol"] < miss


@pytest.mark.parametrize("mutant", F32_WRONG)
def test_wrong_wide_f32_plans_miss_the_jax_kernels(mutant):
    """Each wrong fp32 plan misses JAX's output by more than the card's fp32
    tolerance (1e-4 of max|want|) where the right plan is within 1e-5 (n =
    300: 20 pad keys in the last 32-key tile)."""
    q, k, v, want = _case(300, 2, False)
    inputs = (*map(torch.from_numpy, (q, k, v)), 320**-0.5)
    assert rel(tiled_wide(*inputs, plan="fp32"), want) <= FP32_TOL
    assert rel(tiled_wide(*inputs, plan="fp32", mutant=mutant), want) > MUTANT_TOL


@pytest.mark.parametrize("plan", list(PLANS))
def test_chip_smoke_wide_mutants_are_the_wrong_plans(plan):
    """chip_smoke.wide_mutant_errors, which phase wide holds the card's
    kernel against, measures the same wrong plans (fp32's one-pass plan is
    its ``tf32_plain`` row): each within 5 % of the emulated plan's distance
    from the plain version (the pad-key mutant on the flat inputs)."""
    b, n, h, d = 1, 300, 2, 320
    qkv = chip_smoke.attention_inputs((b, n, h * d), torch.Generator().manual_seed(3), "cpu")
    q, k, v = (x.float().reshape(b, n, h, d) for x in qkv.split(h * d, dim=-1))
    qf = chip_smoke.flat_inputs(q)
    plain = t_flash.flash_attention_plain
    scale = d**-0.5
    got = chip_smoke.wide_mutant_errors(plain, q, k, v, qf, scale, f32=plan == "fp32")
    want, want_flat = plain(q, k, v, scale), plain(qf, k, v, scale)
    wrong = F32_WRONG[:3] + F32_WRONG[4:] if plan == "fp32" else BF16_WRONG
    assert set(got) == set(wrong)
    assert chip_smoke.rel_err(tiled_wide(q, k, v, scale, plan=plan), want) <= 1e-5
    for name in wrong:
        flat = name == "unmasked_zero_pad"
        err = chip_smoke.rel_err(tiled_wide(qf if flat else q, k, v, scale, plan=plan,
                                            mutant=name), want_flat if flat else want)
        assert err > chip_smoke.F32_TOL
        assert abs(got[name] - err) <= 0.05 * err, name


def test_wide_flops_count_the_plan():
    """S once for each 320-column slice, P·V over the slice's 320 columns:
    the dense 4·N²·D at D = 320, 12/7 of it at 448 (two slices), 2304/496
    at 1984 (seven)."""
    for d, ratio in ((320, 1.0), (448, 12 / 7), (1984, 7 * (1984 + 320) / (2 * 1984))):
        assert t_flash.wide_flops(2, 300, 3, d) == pytest.approx(ratio * 4.0 * 2 * 3 * 300**2 * d)
    assert t_flash.WIDE_SLICE == 5 * t_flash.WIDE_PANEL
    assert t_flash.wide_f32_scratch_elems(2, 300, 3, 320) == 4 * 2 * 300 * 3 * 320 + 2 * 2 * 320 * 3 * 320


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
