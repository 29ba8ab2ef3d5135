"""``--fp32`` and ``--fp32_island`` of the port on the CPU: the fp32 island
against the JAX package's in bf16, the output tail's refusal under the
island and in fp32, the fp32 gate decisions against JAX's, CPU emulations of
the plans of the fp32 Kernels A, B and C (``csrc/*_f32.cu``) against the
JAX kernels run in interpret mode on fp32 inputs, and the CLI flags.

Kernels A and C compute their products in 3xTF32 on the tensor cores
(every operand split into hi = rna(x) and lo = rna(x − hi), three TF32
products summed in fp32; Kernel C's weights split once on the host, in
``weight_blocks_f32``); Kernel B computes every product with FFMA in fp32.
Each emulation follows its kernel's plan (tiles, online softmax, the q/k/v
and feed-forward chunks of the fp32 weight layout) in fp32 and must come
within 1e-5 of the JAX kernel, relative to max|JAX| (Kernel C: to max|JAX −
x|, the module's own contribution); the same plan with every product's
operands rounded once to TF32 (10 mantissa bits, rounded in numpy: one
TF32 pass) must miss by more, so that the bound tells fp32-accurate
products from one TF32 pass.  ``tests/test_torch_fp32_tiling.py`` holds the
split bit for bit and the plans' other mutants."""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_dispatch import jax_plan, port_plan
from tests.torch_port_helpers import configs, jax_param_shapes, noised_params
from video_depth_anything_torch import run
from video_depth_anything_torch.config import MotionModuleConfig as TCfg
from video_depth_anything_torch.config import get_model_config
from video_depth_anything_torch.io.checkpoint import from_jax_params
from video_depth_anything_torch.models.vda import VDAModel
from video_depth_anything_torch.ops import flash_attention as t_flash
from video_depth_anything_torch.ops import motion_module as t_motion
from video_depth_anything_torch.ops import output_tail as t_tail
from video_depth_anything_torch.ops import temporal_attention as t_temporal
from video_depth_anything_tpu.config import MotionModuleConfig as JCfg
from video_depth_anything_tpu.models.vda import VDAModel as JaxVDA
from video_depth_anything_tpu.ops import pallas_output_stack
from video_depth_anything_tpu.ops.pallas_attention import (
    flash_attention_native,
    spatial_flash_attention,
)
from video_depth_anything_tpu.ops.pallas_motion import fused_motion_module
from video_depth_anything_tpu.ops.pallas_temporal import temporal_attention_window
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FP32_TOL = 1e-5  # the emulation against the JAX kernel in fp32, relative
# Two bf16 evaluations of a 2-block vits on 28x28 frames, one in each
# package: bf16 rounds at different points in the two (fused epilogues, the
# resize), about 2^-8 per rounding through the encoder and the head; both
# sides run the fp32 output_conv2 (measured: 2.2e-2; the island itself moves
# JAX's output by 5.5e-3).
ISLAND_BF16_TOL = 3e-2
LOG2E = 1.0 / math.log(2.0)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero) in numpy, back as fp32: what ``cvt.rna.tf32.f32`` gives."""
    bits = x.detach().float().contiguous().numpy().view(np.uint32)
    out = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    return torch.from_numpy(out.copy())


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its 13 low mantissa bits dropped: what the tensor cores
    read of an fp32 operand that was never rounded."""
    bits = x.detach().float().contiguous().numpy().view(np.uint32)
    return torch.from_numpy((bits & np.uint32(0xFFFFE000)).view(np.float32).copy())


def split_tf32(x: torch.Tensor, mutant=None) -> tuple:
    """``(hi, lo)`` of the 3xTF32 split: hi = rna(x), lo = rna(x − hi).  The
    ``truncating_split`` mutant feeds the raw x as hi (the tensor cores
    truncate it) beside the lo of a rounded hi."""
    hi = tf32(x)
    lo = tf32(x - hi)
    return (tf32_trunc(x) if mutant == "truncating_split" else hi), lo


def tf32_product(a, b, mutant=None) -> torch.Tensor:
    """``a @ b`` as Kernel A's 3xTF32 passes compute it: lo·hi + hi·lo +
    hi·hi into one fp32 sum (products of TF32 values are exact in fp32).
    Mutants: ``one_pass`` (hi·hi), ``two_pass`` (no lo·hi),
    ``truncating_split``; ``use_tf32`` is ``one_pass``."""
    ahi, alo = split_tf32(a, mutant)
    bhi, blo = split_tf32(b, mutant)
    if mutant in ("one_pass", "use_tf32"):
        return ahi @ bhi
    if mutant == "two_pass":
        return ahi @ blo + ahi @ bhi
    return (alo @ bhi + ahi @ blo) + ahi @ bhi


def _rnd(use_tf32: bool):
    return tf32 if use_tf32 else (lambda x: x)


def rel(got, want, base=None) -> float:
    want = torch.as_tensor(np.array(want, np.float32))
    base = want if base is None else want - torch.as_tensor(np.array(base, np.float32))
    return float((torch.as_tensor(got).float() - want).abs().max() / base.abs().max())


# -- the fp32 head island ----------------------------------------------------------


def test_fp32_island_matches_jax_in_bf16():
    """vits widths, 2 encoder blocks, both packages in bf16 with
    ``fp32_head_island``: within ISLAND_BF16_TOL of max|JAX depth|; the
    island changes the port's output (it is wired)."""
    jc, tc = configs("vits", 2)
    jc, tc = (dataclasses.replace(c, fp32_head_island=True) for c in (jc, tc))
    jm = JaxVDA(cfg=jc, dtype=jnp.bfloat16)
    jm.params = noised_params(jax_param_shapes(jm.module, jnp.zeros((1, 2, 28, 28, 3))), 4)
    tm = VDAModel(cfg=tc, device="cpu", dtype=torch.bfloat16)
    tm.load_state_dict(from_jax_params(jm.params, jc), strict=True)
    x = np.random.RandomState(11).randn(1, 4, 42, 56, 3).astype(np.float32)
    want = np.asarray(jm.infer_window(x).astype(jnp.float32))
    got = tm.infer_window(x).float()
    assert got.shape == want.shape == x.shape[:4]
    assert rel(got, want) <= ISLAND_BF16_TOL
    plain = VDAModel(cfg=dataclasses.replace(tc, fp32_head_island=False), device="cpu",
                     dtype=torch.bfloat16)
    plain.module.load_state_dict(tm.module.state_dict())
    assert not torch.equal(plain.infer_window(x).float(), got)


@pytest.mark.parametrize("island,dtype", [(True, torch.bfloat16), (False, torch.float32),
                                          (False, torch.bfloat16)])
def test_tail_gate_refuses_under_the_island_and_in_fp32(island, dtype, monkeypatch):
    """vitl at 518² is the tail kernel's shape: the gate says yes in bf16
    without the island alone, as JAX's: ``models/dpt.py:202`` refuses under
    the island, and the kernel's gate (``pallas_output_stack.py:587``, run
    here with the kernel replaced by a tag and a TPU assumed) any dtype but
    bf16."""
    cfg = dataclasses.replace(get_model_config("vitl"), fp32_head_island=island)
    shape = (32, 296, 296, 128)
    monkeypatch.setattr(pallas_output_stack, "fused_output_tail", lambda *a, **k: "kernel")
    monkeypatch.setattr(pallas_output_stack, "_on_tpu", lambda: True)
    spec = type("Spec", (), dict(shape=shape, ndim=4, dtype=jnp.dtype(str(dtype).split(".")[1])))
    k1, k2 = np.empty((3, 3, 128, 32), np.float32), np.empty((1, 1, 32, 1), np.float32)
    jax_kernel_gate = pallas_output_stack.try_fused_output_tail(spec(), k1, None, k2, None,
                                                                518, 518) is not None
    got = t_tail.output_tail_gate(cfg, shape, dtype, 518, 518)
    assert got is (jax_kernel_gate and not island)
    assert got is (not island and dtype == torch.bfloat16)


@pytest.mark.parametrize("impl", ["auto", "pallas"])
@pytest.mark.parametrize("encoder,h,w", [(e, h, w) for e in ("vits", "vitb", "vitl")
                                         for h, w in ((518, 518), (518, 924))])
def test_fp32_gate_decisions_match_jax(encoder, h, w, impl, monkeypatch):
    """Every motion module, the ViT's attention and the tail at fp32: the
    port's gates decide as JAX's do on fp32 arrays (the motion and temporal
    gates read no dtype in either package; the tail refuses fp32)."""
    got = port_plan(encoder, h, w, impl, dtype="float32")
    assert got == jax_plan(encoder, h, w, monkeypatch, impl, dtype="float32")
    assert got["tail"] == "plain"
    bf16 = port_plan(encoder, h, w, impl)
    assert {k: v for k, v in got.items() if k != "tail"} == \
        {k: v for k, v in bf16.items() if k != "tail"}


# -- Kernel A -------------------------------------------------------------------------


FLASH_F32_PLAN = {64: (128, 64), 192: (64, 32)}  # D: (query rows a CTA, keys a tile)


def emulate_flash_f32(q, k, v, scale, fast=False, use_tf32=False, mutant=None):
    """``(B, N, H, D)`` fp32 → the plan of ``flash_fwd_f32<D, FAST>``: CTAs
    of 128 query rows (two 64-row consumer warpgroups) and 64-key tiles at
    D = 64, 64 rows and 32-key tiles at D = 192; q scaled by scale · log2 e
    in fp32, then split; K and V tiles zero-filled past N (TMA) and split;
    S = Q Kᵀ in 3xTF32, keys past N masked to −inf; online exp2 softmax
    (FAST: m = 0, no rescale); p split; O = O · α + P V in 3xTF32; then
    O / l.  ``use_tf32``: one TF32 pass (hi·hi) everywhere.  ``mutant``:
    ``one_pass``, ``two_pass``, ``truncating_split`` (``tf32_product``) or
    ``unmasked_pad`` (TMA's zero keys left in the softmax)."""
    mutant = "use_tf32" if use_tf32 else mutant
    b, n, h, d = q.shape
    rows, kt = FLASH_F32_PLAN[d]
    qs = q.float().permute(0, 2, 1, 3) * (scale * LOG2E)
    npad = -(-n // kt) * kt
    kp, vp = (torch.nn.functional.pad(x.float().permute(0, 2, 1, 3), (0, 0, 0, npad - n))
              for x in (k, v))
    out = torch.empty(b, h, n, d)
    for i in range(0, n, rows):  # one CTA; pad query rows are never stored
        qi = qs[:, :, i:i + rows]
        m = torch.full(qi.shape[:3], 0.0 if fast else -math.inf)
        l = torch.zeros(qi.shape[:3])
        acc = torch.zeros(qi.shape)
        for j in range(0, n, kt):  # a key tile
            s = tf32_product(qi, kp[:, :, j:j + kt].transpose(-1, -2), mutant)
            if mutant != "unmasked_pad" and n - j < kt:
                s[..., n - j:] = -math.inf
            if not fast:
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp2(m - m_new)
                m, l, acc = m_new, l * alpha, acc * alpha[..., None]
            p = torch.exp2(s - m[..., None])
            l = l + p.sum(-1)
            acc = acc + tf32_product(p, vp[:, :, j:j + kt], mutant)
        out[:, :, i:i + rows] = acc / l[..., None]
    return out.permute(0, 2, 1, 3)


def _jax_flash(q, k, v, fast=False):
    """The JAX package's dispatch on fp32 inputs: the native-layout kernel
    for even heads and at most 2048 padded keys at D = 64, else the
    whole-row or blocked kernel."""
    b, n, h, d = q.shape
    if d == 64 and h % 2 == 0 and -(-n // 128) * 128 <= 2048:
        out = flash_attention_native(*(jnp.asarray(x.reshape(b, n, h * d)) for x in (q, k, v)),
                                     scale=d**-0.5, n_valid=n, num_heads=h, fast_softmax=fast,
                                     interpret=True)
        return np.asarray(out).reshape(b, n, h, d)
    return np.asarray(spatial_flash_attention(*(jnp.asarray(x) for x in (q, k, v)), d**-0.5,
                                              fast_softmax=fast, interpret=True))


@pytest.mark.parametrize("d,n", [(64, 300), (64, 1370), (192, 300), (192, 1370)])
def test_flash_f32_plan_matches_jax_kernel(d, n):
    rng = np.random.RandomState(d + n)
    q, k, v = (rng.randn(1, n, 2, d).astype(np.float32) for _ in range(3))
    want = _jax_flash(q, k, v)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = emulate_flash_f32(tq, tk, tv, d**-0.5)
    assert rel(got, want) <= FP32_TOL
    assert rel(t_flash.flash_attention_plain(tq, tk, tv, d**-0.5), want) <= FP32_TOL
    assert rel(emulate_flash_f32(tq, tk, tv, d**-0.5, use_tf32=True), want) > FP32_TOL


def test_flash_f32_fast_plan_matches_plain():
    """The FAST plan (no max, no rescale) at D = 64 against the plain fast
    softmax in fp32."""
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(1, 300, 2, 64).astype(np.float32)) for _ in range(3))
    want = t_flash.flash_attention_plain(q, k, v, 0.125, fast=True)
    assert rel(emulate_flash_f32(q, k, v, 0.125, fast=True), want) <= FP32_TOL


# -- Kernel B -------------------------------------------------------------------------


def temporal_f32_unit(d: int) -> tuple:
    """``(query frames a unit, lanes a query row, columns a P·V pass)`` of
    ``temporal_f32<d>`` (``unit_frames``, ``row_lanes``, ``pass_cols``): a
    lane's QF · KL / 32 query frames × DC columns are 32 accumulators."""
    qf = 32 if d <= 32 else 16 if d <= 64 else 8
    kl = 4 if d <= 64 else 8
    return qf, kl, 32 // (qf * kl // 32)


def emulate_temporal_f32(q, k, v, heads, scale, use_tf32=False, mutant=None, grid=3):
    """``(B, T, S, C)`` fp32 → the plan of ``temporal_f32<d>``: ``grid``
    persistent CTAs walk the tiles of ``tile_plan(C, heads, 4)`` (tile = CTA
    + it · grid; the kernel takes one location a tile where these would not
    cover the card's SMs, which changes no unit's arithmetic), each through
    its own two-stage ring whose rows are never
    loaded past T (stale: NaN here before a first copy) but for v's, zeroed
    once; units of (location, head, QF query frames); the scores of 32 key
    frames, keys at or past T masked to −inf, an exact exp2 softmax, p ·
    1/l; P·V as the KL lanes' partial sums over keys c + KL·j, reduced in
    pairs by lane (xor 1, then 2, then 4); rows at or past T and locations
    past S never stored.  ``mutant``: ``stale_stage`` (a stage read before its
    copy lands: the CTA's tile of two steps before, or NaN),
    ``unmasked_keys`` (stale key rows left in the softmax) or
    ``v_rows_not_zeroed``."""
    rnd = _rnd(use_tf32)
    b, t, s, c = q.shape
    d = c // heads
    locs, group = t_temporal.tile_plan(c, heads, 4)
    cg = group * d
    qf, kl, _ = temporal_f32_unit(d)
    sblocks, hgroups = -(-s // locs), heads // group
    tiles = b * sblocks * hgroups
    out = torch.full((b, t, s, c), math.nan)
    for cta in range(grid):
        ring = torch.full((2, 3, 32, locs, cg), math.nan)
        if mutant != "v_rows_not_zeroed":
            ring[:, 2, t:] = 0.0
        for it, tile in enumerate(range(cta, tiles, grid)):
            hg, r = tile % hgroups, tile // hgroups
            sb, bi = r % sblocks, r // sblocks
            s0, c0 = sb * locs, hg * cg
            lv = min(locs, s - s0)
            stage = ring[it % 2]
            copy = [rnd(x[bi, :, s0:s0 + lv, c0:c0 + cg].float()) for x in (q, k, v)]
            if mutant == "stale_stage":  # the consumers see the stage before the copy lands
                stage = stage.clone()
            for x in range(3):
                ring[it % 2, x, :t, :lv] = copy[x]
            for l in range(lv):
                for h in range(group):
                    qh, kh, vh = (stage[x, :, l, h * d:(h + 1) * d] for x in range(3))
                    for f0 in range(0, min(t, 32), qf):
                        sc = (qh[f0:f0 + qf] @ kh.T) * (scale * LOG2E)
                        if mutant != "unmasked_keys":
                            sc[:, t:] = -math.inf
                        p = torch.exp2(sc - sc.amax(-1, keepdim=True))
                        p = rnd(p * (1.0 / p.sum(-1, keepdim=True)))
                        part = [p[:, j::kl] @ vh[j::kl] for j in range(kl)]
                        while len(part) > 1:
                            part = [part[j] + part[j + 1] for j in range(0, len(part), 2)]
                        o = part[0]
                        rows = min(qf, t - f0)
                        out[bi, f0:f0 + rows, s0 + l, c0 + h * d:c0 + (h + 1) * d] = o[:rows]
    return out


@pytest.mark.parametrize("t", [8, 17, 32])
@pytest.mark.parametrize("d", [8, 48, 128])
def test_temporal_f32_plan_matches_jax_kernel(d, t):
    """S = 7: a ragged last location tile at C = 64 (two locations a tile
    in fp32); d = 48 and 128 take 16 and 8 query frames a unit."""
    c, s, heads = 8 * d, 7, 8
    rng = np.random.RandomState(d * 100 + t)
    q, k, v = (rng.randn(2, t, s, c).astype(np.float32) for _ in range(3))
    want = np.asarray(temporal_attention_window(*(jnp.asarray(x) for x in (q, k, v)), heads=heads,
                                                scale=d**-0.5, interpret=True))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    assert rel(emulate_temporal_f32(tq, tk, tv, heads, d**-0.5), want) <= FP32_TOL
    assert rel(emulate_temporal_f32(tq, tk, tv, heads, d**-0.5, use_tf32=True), want) > FP32_TOL


@pytest.mark.parametrize("c,plan", [(64, (2, 8)), (128, (1, 8)), (192, (1, 4)), (256, (1, 4)),
                                    (384, (1, 2)), (1024, (1, 1))])
def test_temporal_tile_plan_at_fp32(c, plan):
    """128 channels a tile in fp32 (512-byte frame runs)."""
    assert t_temporal.tile_plan(c, 8, 4) == plan


# -- Kernel C -------------------------------------------------------------------------


def _ln(y, g, b, eps):
    mean = y.mean(-1, keepdim=True)
    var = torch.clamp((y * y).mean(-1, keepdim=True) - mean * mean, min=0.0)
    return (y - mean) * (torch.rsqrt(var + eps) * g) + b


def f32_panel_order() -> list:
    """The input held at each logical position L of a 32-input panel of the
    fp32 Kernel C's weight tiles: the tf32 A fragment's slot j of k8 step
    t takes input 4 (j % 4) + 2 t + j // 4 of its 16-input unit, so that a
    thread's (c, c + 4) slots of both steps are one 16-byte load of columns
    4c .. 4c + 3."""
    return [16 * (L // 16) + 4 * (L % 4) + 2 * ((L // 8) % 2) + (L % 8) // 4 for L in range(32)]


def decode_f32_blocks(flat: torch.Tensor) -> torch.Tensor:
    """``weight_blocks_f32``'s blocks (each a hi tile then a lo tile: 64
    output columns × 32 inputs, 16-byte chunk j of row n at j ^ (n % 8),
    the inputs in ``f32_panel_order``) → ``(blocks, 2, 32 inputs, 64
    outputs)``, hi then lo, the inputs in their own order."""
    rows = torch.arange(64)
    src = torch.arange(8)[None, :] ^ (rows % 8)[:, None]
    logical = flat.reshape(-1, 2, 64, 8, 4)[:, :, rows[:, None], src].reshape(-1, 2, 64, 32)
    out = torch.empty_like(logical)
    out[..., f32_panel_order()] = logical
    return out.transpose(-1, -2)


class MotionRing:
    """The fp32 Kernel C's weight blocks as its consumer warpgroups read
    them: one sequence a warpgroup (their lengths counted here as the
    kernel's ``Shape::blocks`` counts them), each read in order."""

    def __init__(self, flat: torch.Tensor, c: int, heads: int = 8):
        self.ns = t_motion.F32_PLAN[c][0]
        d = c // heads
        kp, nsw, nchk = c // 32, c // 64 // self.ns, c // (d * (64 // d))
        fs = 4 * c // (64 * self.ns)
        lens = [2 * nsw * kp + 2 * nchk * (len(range(cs, 3, self.ns)) * kp + 2 * nsw)
                + fs * (2 * kp + 2 * self.ns * nsw) for cs in range(self.ns)]
        assert flat.numel() == 4096 * sum(lens)
        self.blocks = decode_f32_blocks(flat)
        self.pos = [sum(lens[:cs]) for cs in range(self.ns)]
        self.end = [sum(lens[:cs + 1]) for cs in range(self.ns)]

    def matrix(self, panels: int, owners: list) -> tuple:
        """``(hi, lo)`` of a product's ``(32 panels, 64 len(owners))``
        weight: output block n from warpgroup ``owners[n]``'s sequence,
        each warpgroup taking its blocks in order of n, each over all its
        panels."""
        hi = torch.zeros(32 * panels, 64 * len(owners))
        lo = torch.zeros_like(hi)
        for n, cs in enumerate(owners):
            for kp in range(panels):
                assert self.pos[cs] < self.end[cs], "a warpgroup read past its sequence"
                block = self.blocks[self.pos[cs]]
                self.pos[cs] += 1
                hi[32 * kp:32 * kp + 32, 64 * n:64 * n + 64] = block[0]
                lo[32 * kp:32 * kp + 32, 64 * n:64 * n + 64] = block[1]
        return hi, lo


def product_3xtf32(a: torch.Tensor, w: tuple, mutant=None) -> torch.Tensor:
    """``a @ w`` as the kernel's wgmma passes compute it, from the split
    weight ``w = (hi, lo)`` and ``a`` split as the kernel splits it in
    registers: lo·hi + hi·lo + hi·hi in fp32.  Mutants: ``one_pass``
    (hi·hi: one TF32 pass), ``two_pass`` (no lo·hi), ``truncating_split``
    (the raw operands, read truncated by the tensor cores, as hi)."""
    whi, wlo = w
    if mutant == "truncating_split":
        whi = tf32_trunc(whi + wlo)
    ahi, alo = split_tf32(a, mutant)
    if mutant == "one_pass":
        return ahi @ whi
    if mutant == "two_pass":
        return ahi @ wlo + ahi @ whi
    return (alo @ whi + ahi @ wlo) + ahi @ whi


def emulate_motion_f32(x, p, cfg, heads, mutant=None):
    """``(B, T, S, C)`` fp32 → the plan of ``motion_f32``: CTAs of 64 rows
    (64 / T locations, location major; locations past S zero rows, never
    stored), every product in 3xTF32 (``product_3xtf32``) over the weight
    blocks of ``weight_blocks_f32`` read from each warpgroup's sequence in
    the kernel's order (``MotionRing``): proj_in on the GroupNorm applied at
    the load; per attention block LayerNorm + APE applied once a row, per
    chunk of ``chunk_channels`` q | k | v
    (64-column blocks, padded), attention per (location, head) in fp32, the
    out projection accumulated over the chunks (64 inputs, padded), then +
    b_o and the residual; the feed-forward in steps of nsplit 64-column
    hidden chunks (h, gate, erf GELU, w2 accumulated over the steps); proj_out;
    + x.  Mutants: those of ``product_3xtf32``; ``wrong_block`` (the
    feed-forward's h and gate products each read the other's blocks);
    ``stats_wrong_block`` (each row's LayerNorm statistics from the same
    row of the next CTA's 64-row block); ``unmasked_keys`` (the padded
    frames' keys let into the frame attention).  T pads up to Tp = 8, 16
    or 32 rows a location: rows t ≥ T zero, masked as keys, without APE,
    never stored."""
    b, t, s, c = x.shape
    tp = t_motion.padded_frames(t)
    w = t_motion.kernel_weights(p, cfg, torch.float32)
    gna, gnb = (torch.cat([g, torch.zeros(b, tp - t, c)], 1) for g in t_motion.gn_fold(x, w, cfg))
    pe = torch.cat([w["pe"][:t], torch.zeros(tp - t, c)])
    ring = MotionRing(w["w"], c, heads)
    ns, d = ring.ns, c // heads
    nch = t_motion.chunk_channels(c, heads)
    locs = 64 // tp
    ncta = -(-s // locs)
    rows = b * ncta * 64
    xs = torch.zeros(b, ncta * locs, tp, c)
    xs[:, :s, :t] = x.permute(0, 2, 1, 3)
    xr = xs.reshape(b, ncta, 64, c)
    frame = torch.arange(64) % tp
    y = (xr * gna[:, None, frame] + gnb[:, None, frame]).reshape(rows, c)
    frames = frame.repeat(b * ncta)
    out_owners = [n % ns for n in range(c // 64)]
    mm = lambda a, panels, owners: product_3xtf32(a, ring.matrix(panels, owners), mutant)  # noqa: E731

    def ln(y, i, ape):
        mean = y.mean(-1, keepdim=True)
        rstd = torch.rsqrt(torch.clamp((y * y).mean(-1, keepdim=True) - mean * mean, min=0.0)
                           + cfg.layer_norm_eps)
        if mutant == "stats_wrong_block":
            mean, rstd = mean.roll(-64, 0), rstd.roll(-64, 0)
        h = (y - mean) * (rstd * w["ln_scale"][i]) + w["ln_bias"][i]
        return h + pe[frames] if ape else h

    y = mm(y, c // 32, out_owners) + w["b_in"]
    for i in range(2):
        h = ln(y, i, True)
        acc = torch.zeros(rows, c)
        for _ in range(c // nch):
            qkv = mm(h, c // 32, [n % ns for n in range(3)])
            q, k, v = (qkv[:, 64 * j:64 * j + nch].reshape(-1, tp, nch // d, d) for j in range(3))
            sc = torch.einsum("lqhd,lkhd->lhqk", q, k) * (d**-0.5 * LOG2E)
            if mutant != "unmasked_keys":
                sc[..., t:] = -math.inf
            pr = torch.exp2(sc - sc.amax(-1, keepdim=True))
            o = torch.einsum("lhqk,lkhd->lqhd", pr, v) / pr.sum(-1).permute(0, 2, 1)[..., None]
            oa = torch.zeros(rows, 64)
            oa[:, :nch] = o.reshape(rows, nch)
            acc = acc + mm(oa, 2, out_owners)
        y = y + (acc + w["bo"][i])
    h = ln(y, 2, False)
    acc = torch.zeros(rows, c)
    for f in range(4 * c // (64 * ns)):
        wh, wg = ring.matrix(c // 32, list(range(ns))), ring.matrix(c // 32, list(range(ns)))
        if mutant == "wrong_block":
            wh, wg = wg, wh
        cols = slice(f * ns * 64, (f + 1) * ns * 64)
        hh = product_3xtf32(h, wh, mutant) + w["b1"][cols]
        g = product_3xtf32(h, wg, mutant) + w["b1"][4 * c:][cols]
        acc = acc + mm(hh * (0.5 * g * (1 + torch.erf(g * 0.7071067811865476))), 2 * ns,
                       out_owners)
    y = y + (acc + w["b2"])
    res = mm(y, c // 32, out_owners) + w["b_out"] + xs.reshape(rows, c)
    assert ring.pos == ring.end, "every warpgroup reads its whole sequence"
    return res.reshape(b, ncta * locs, tp, c)[:, :s, :t].permute(0, 2, 1, 3)


def _motion_params(c, seed):
    rng = np.random.default_rng(seed)
    n = lambda *s, std=1.0: torch.from_numpy((rng.standard_normal(s) * std).astype(np.float32))  # noqa: E731
    return dict(gn_scale=1 + n(c, std=0.1), gn_bias=n(c, std=0.1), w_in=n(c, c, std=c**-0.5),
                b_in=n(c, std=0.1), ln_scale=1 + n(3, c, std=0.1), ln_bias=n(3, c, std=0.1),
                wq=n(2, c, c, std=c**-0.5), wk=n(2, c, c, std=c**-0.5), wv=n(2, c, c, std=c**-0.5),
                wo=n(2, c, c, std=c**-0.5), bo=n(2, c, std=0.1), w1=n(c, 8 * c, std=c**-0.5),
                b1=n(8 * c, std=0.1), w2=n(4 * c, c, std=(4 * c) ** -0.5), b2=n(c, std=0.1),
                w_out=n(c, c, std=c**-0.5), b_out=n(c, std=0.1))


def test_motion_f32_plan_matches_jax_kernel():
    """C = 64, T = 8 (8 locations a CTA), S = 10: a ragged last CTA; one TF32
    pass misses."""
    c, t, s = 64, 8, 10
    p = _motion_params(c, 5)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((1, t, s, c)).astype(np.float32))
    want = np.asarray(fused_motion_module(jnp.asarray(x.numpy()),
                                          {k: jnp.asarray(v.numpy()) for k, v in p.items()},
                                          heads=8, cfg=JCfg(), interpret=True))
    got = emulate_motion_f32(x, p, TCfg(), 8)
    assert rel(got, want, x) <= FP32_TOL
    assert rel(t_motion.motion_module_plain(x, p, TCfg(), 8), want, x) <= FP32_TOL
    assert rel(emulate_motion_f32(x, p, TCfg(), 8, mutant="one_pass"), want, x) > FP32_TOL


@pytest.mark.parametrize("c", [128, 192, 384])
def test_motion_f32_plan_matches_plain_at_other_widths(c):
    """The chunks of the other widths (d = 16: 64-channel chunks; d = 24
    and 48: 48-channel chunks), T = 16 and 32, against the plain module."""
    t, s = (16, 3) if c == 128 else (32, 2)
    p = _motion_params(c, c)
    x = torch.from_numpy(np.random.default_rng(c).standard_normal((1, t, s, c)).astype(np.float32))
    want = t_motion.motion_module_plain(x, p, TCfg(), 8)
    assert rel(emulate_motion_f32(x, p, TCfg(), 8), want, x) <= FP32_TOL


@pytest.mark.parametrize("c", [64, 192, 128, 256, 384])
def test_weight_matrices_f32_layout(c):
    """The fp32 weight buffer (``weight_blocks_f32``, ``f32_weight_blocks``
    blocks) read as the kernel's warpgroups read it gives the raw weights'
    3xTF32 split bit for bit: proj_in, each chunk's q, k and v (padded
    columns zero), w_o's rows of the chunk (padded rows zero), w1's h and
    gate columns and w2's rows of each step, proj_out; nothing is left
    over."""
    p = _motion_params(c, 1)
    flat = t_motion.weight_blocks_f32(p)
    assert flat.numel() == 4096 * t_motion.f32_weight_blocks(c)
    ring = MotionRing(flat, c)
    ns, nch, kp = ring.ns, t_motion.chunk_channels(c), c // 32
    out_owners = [n % ns for n in range(c // 64)]

    def same(got, w):
        hi = tf32(w)
        assert torch.equal(got[0], hi) and torch.equal(got[1], tf32(w - hi))

    same(ring.matrix(kp, out_owners), p["w_in"])
    for i in range(2):
        for ch in range(c // nch):
            cols = slice(ch * nch, (ch + 1) * nch)
            qkv = ring.matrix(kp, [n % ns for n in range(3)])
            for j, name in enumerate(("wq", "wk", "wv")):
                same(tuple(m[:, 64 * j:64 * j + nch] for m in qkv), p[name][i][:, cols])
                assert not any(m[:, 64 * j + nch:64 * j + 64].any() for m in qkv)
            wo = ring.matrix(2, out_owners)
            same(tuple(m[:nch] for m in wo), p["wo"][i][cols])
            assert not any(m[nch:].any() for m in wo)
    for f in range(4 * c // (64 * ns)):
        cols = slice(f * ns * 64, (f + 1) * ns * 64)
        same(ring.matrix(kp, list(range(ns))), p["w1"][:, cols])
        same(ring.matrix(kp, list(range(ns))), p["w1"][:, 4 * c:][:, cols])
        same(ring.matrix(2 * ns, out_owners), p["w2"][cols])
    same(ring.matrix(kp, out_owners), p["w_out"])
    assert ring.pos == ring.end


def test_kernel_weights_cached_by_dtype():
    """TemporalModule keeps one prepared layout per dtype, each rebuilt when
    a parameter changes."""
    from video_depth_anything_torch.models.temporal import TemporalModule

    mod = TemporalModule(TCfg(), 64)
    bf, f32 = mod.kernel_weights(), mod.kernel_weights(torch.float32)
    assert bf["w"].dtype == torch.bfloat16 and f32["w"].dtype == torch.float32
    assert f32["pe"].dtype == torch.float32 and mod.kernel_weights(torch.float32) is f32
    assert mod.kernel_weights() is bf
    with torch.no_grad():
        mod.temporal_transformer.proj_in.weight.add_(1.0)
    again = mod.kernel_weights(torch.float32)
    assert again is not f32
    torch.testing.assert_close(again["w"], t_motion.weight_blocks_f32(mod.raw_params()),
                               rtol=0, atol=0)


# -- the CLI ----------------------------------------------------------------------------


def test_cli_takes_fp32_island(monkeypatch, tmp_path):
    """``--fp32_island`` parses, survives ``normalize_args`` and gives
    ``VDAModel`` the config with ``fp32_head_island`` in bf16 only (JAX
    ``run.py:205-211``)."""
    args = run.normalize_args(run.build_parser().parse_args(
        ["--input_video", "clip.mp4", "--fp32_island", "--original"]))
    assert args.fp32_island and not args.fp32
    seen = []

    class Stop(Exception):
        pass

    def fake_model(encoder, device=None, dtype=None, cfg=None, attn_impl="auto"):
        seen.append((dtype, cfg))
        raise Stop

    import video_depth_anything_torch.models.vda as vda

    monkeypatch.setattr(vda, "VDAModel", fake_model)
    for extra, dtype, island in (([], torch.bfloat16, True), (["--fp32"], torch.float32, None)):
        with pytest.raises(Stop):
            run.main(["--input_video", "clip.mp4", "--fp32_island", "--device", "cpu",
                      "--output_dir", str(tmp_path)] + extra)
        got_dtype, cfg = seen[-1]
        assert got_dtype == dtype
        assert (cfg.fp32_head_island if cfg is not None else None) is island


def test_fp32_launch_counts_have_names_of_their_own():
    counts = run.kernel_launches()
    assert {"flash_attention_f32", "temporal_attention_f32", "fused_motion_module_f32"} <= set(counts)
