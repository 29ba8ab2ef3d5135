"""The tilings of the probes' Hopper kernels
(``csrc/attention_variants_hopper.cu``: ``ilv_hopper<NOMASK>``,
``chunk_hopper``, ``sbf16_hopper<FAST, CEILING>`` and
``chain_hopper<MODE>``), emulated in torch on the CPU, against the
TPU kernels of ``scripts/bench_spatial_variants.py`` (``run_variant``) and
``scripts/bench_softmax_chain.py`` (``kern``) in Pallas interpret mode on
the same seeded inputs.

The emulation follows the kernels' plan: CTAs of 128 query rows in two
64-row warpgroups, 64-key tiles up to round_up(n, 128) with zero-filled pad
rows, q prescaled by scale·log2 e in fp32 and rounded to bf16 in shared
memory, the kernels' ``exp2_poly`` (the floor by a rounding-down add), P
rounded to bf16 before P·V.  ``ilv`` takes the per-tile order of both heads
(S0, S1, chain 0, P0·V0, chain 1, P1·V1); ``chunk`` the flat (stream, key
tile) pipeline with its two S/P slots, its two Q slots and the
stream-boundary hand-off of l; ``sbf16`` the kernel's two passes in exact
mode (the row max of the fp32 scores over the valid keys, rounded to bf16
once), its score rounding (``cvt.rn.bf16x2.f32`` on a pair, the halves
shifted back) and the mask on the last key tiles only.  Mutants must miss
by more than ``chip_smoke.ATTN_TOL``: P·V reading the other slot's P, a
stream's output stored in the other head of the pair, q scaled after the
bf16 rounding (the scale folded into the scores) in place of before, and
for ``sbf16`` a running max in place of the global one and the mask
dropped.

The chain kernel's plan (``emulate_chain``): 128-row query blocks with
TMA's zero-filled partial block, 64-key tiles through a ring of six
stages (pass 1's K tiles, then pass 2's K and V tiles), S in fp32, each
mode's chain (``exact``'s online max with rescale, ``bf16x``'s first pass
over K for the global max of the scores, rounded once), P rounded to
bf16, the unnormalised (P·V)[:, :64].  Its mutants: ``bf16x`` with an
online max (no rescale) in place of the first pass, ``bf16x`` reading
pass 2's V from the stage without pass 1's offset, and a stage released
after S instead of after P·V, so that a later load overwrites V before
P·V reads it."""

import functools
import importlib.util
import math
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl

import chip_smoke
from tests.torch_port_helpers import chain_kern
from video_depth_anything_torch.ops import attention_variants as av
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parent.parent
BF16_ULP = 2.0**-8
# emulation and TPU kernel (interpret) round at the same points and differ
# in fp32 summation order: within 2 bf16 ulps of max|output|
TOL = 2 * BF16_ULP
SCALE = 64**-0.5


@pytest.fixture(scope="module")
def bsv():
    """``scripts/bench_spatial_variants.py`` with ``pl.pallas_call`` in
    interpret mode: its ``pl`` swapped for a namespace, nothing edited."""
    spec = importlib.util.spec_from_file_location(
        "bench_spatial_variants", ROOT / "scripts" / "bench_spatial_variants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True), BlockSpec=pl.BlockSpec)
    return mod


def _round_up(x, m):
    return -(-x // m) * m


def _bf16(t):
    return t.to(torch.bfloat16).float()


def kernel_exp2(x):
    """``exp2_poly`` as the Hopper kernels compute it: x clamped at −127,
    the floor (there: ``__fadd_rd(x, 1.5·2²³) − 1.5·2²³``), the exponent
    clamped at 127 and built in the exponent field."""
    x = torch.clamp(x, min=-127.0)
    fl = torch.floor(x)
    xf = x - fl
    sc = ((torch.clamp(fl, max=127.0).to(torch.int32) + 127) << 23).view(torch.float32)
    c = av.EXP2_C
    return sc * (c[0] + xf * (c[1] + xf * (c[2] + xf * (c[3] + xf * c[4]))))


def _prescale(q_rows, c, mutant):
    """A warpgroup's Q rows as the product reads them: q·c rounded to bf16,
    or under the mutant raw bf16 q (the scale then goes on the scores)."""
    return q_rows if mutant == "q_scaled_after_rounding" else _bf16(q_rows * c)


def _scores(qs, kt, c, mutant):
    s = qs @ kt.mT
    return s * c if mutant == "q_scaled_after_rounding" else s


def _operands(q, k, v, rows):
    """fp32 copies: q zero-padded to ``rows`` query rows, k and v to
    round_up(n, 128) keys (TMA's zero fill)."""
    n = q.shape[1]
    n_pad = _round_up(n, 128)
    return (F.pad(q.float(), (0, 0, 0, rows - n)), F.pad(k.float(), (0, 0, 0, n_pad - n)),
            F.pad(v.float(), (0, 0, 0, n_pad - n)), n_pad)


def emulate_ilv(q, k, v, heads, nomask, mutant=None):
    b, n, hd = q.shape
    c = torch.tensor(SCALE * av.LOG2E, dtype=torch.float32)
    ctas = _round_up(n, 128) // 128
    qp, kp, vp, n_pad = _operands(q, k, v, ctas * 128)
    out = torch.zeros(b, n, hd)
    key_idx = torch.arange(n_pad)
    for x in range(ctas):
        for pair in range(heads // 2):
            cols = [slice((2 * pair + h) * 64, (2 * pair + h + 1) * 64) for h in range(2)]
            for cw in range(2):
                r0 = x * 128 + cw * 64
                qs = [_prescale(qp[:, r0:r0 + 64, cl], c, mutant) for cl in cols]
                o = [torch.zeros(b, 64, 64), torch.zeros(b, 64, 64)]
                l = [torch.zeros(b, 64), torch.zeros(b, 64)]
                for j in range(n_pad // 64):
                    keys = slice(j * 64, (j + 1) * 64)
                    s = [_scores(qs[h], kp[:, keys, cols[h]], c, mutant) for h in range(2)]
                    for h in range(2):  # chain 0, P0 V0, then chain 1, P1 V1
                        sh = s[h] if nomask else torch.where(key_idx[keys] < n, s[h], -1e30)
                        p = kernel_exp2(sh)
                        l[h] += p.sum(-1)
                        o[h] += _bf16(p) @ vp[:, keys, cols[h]]
                m = min(64, n - r0)
                for h in range(2):
                    if m > 0:
                        lh = l[h] - (n_pad - n if nomask else 0)
                        out[:, r0:r0 + m, cols[h]] = (o[h] / lh[..., None])[:, :m]
    return out.to(torch.bfloat16)


def emulate_chunk(q, k, v, heads, nc, mutant=None):
    b, n, hd = q.shape
    c = torch.tensor(SCALE * av.LOG2E, dtype=torch.float32)
    ctas = -(-(_round_up(n, 128) // 128) // nc)
    qp, kp, vp, n_pad = _operands(q, k, v, ctas * nc * 128)
    kt = n_pad // 64
    out = torch.zeros(b, n, hd)
    for x in range(ctas):
        row0 = x * nc * 128
        nct = min(nc, -(-(n - row0) // 128))  # chunks with real rows
        steps = 2 * nct * kt
        for pair in range(heads // 2):
            def head(st):  # stream st = head * nct + chunk
                return 2 * pair + st // nct

            for cw in range(2):
                def first_row(st):
                    return row0 + (st % nct) * 128 + cw * 64

                q_slot, s_slot, p_slot = [None, None], [None, None], [None, None]
                l_cur, l_fin, acc = torch.zeros(b, 64), None, None
                for i in range(steps + 2):
                    if i < steps:  # S(i)
                        st, h = i // kt, head(i // kt)
                        if i % kt == 0:
                            r0 = first_row(st)
                            q_slot[st % 2] = _prescale(qp[:, r0:r0 + 64, h * 64:(h + 1) * 64],
                                                       c, mutant)
                        j = i % kt
                        s_slot[i % 2] = _scores(q_slot[st % 2],
                                                kp[:, j * 64:(j + 1) * 64, h * 64:(h + 1) * 64],
                                                c, mutant)
                    if 1 <= i <= steps:  # the chain of step i - 1
                        p = kernel_exp2(s_slot[(i - 1) % 2])
                        l_cur = l_cur + p.sum(-1)
                        p_slot[(i - 1) % 2] = _bf16(p)
                        if (i - 1) % kt == kt - 1:
                            l_fin, l_cur = l_cur, torch.zeros(b, 64)
                    if i >= 2:  # P V(i - 2); the stream's output after its last
                        jj = i - 2
                        st, h, j = jj // kt, head(jj // kt), jj % kt
                        slot = (i - 1) % 2 if mutant == "p_other_slot" else jj % 2
                        term = p_slot[slot] @ vp[:, j * 64:(j + 1) * 64, h * 64:(h + 1) * 64]
                        acc = term if j == 0 else acc + term
                        if j == kt - 1:
                            oh = h ^ 1 if mutant == "output_other_head" else h
                            r0 = first_row(st)
                            m = min(64, n - r0)
                            if m > 0:
                                out[:, r0:r0 + m, oh * 64:(oh + 1) * 64] = (
                                    acc / (l_fin - (n_pad - n))[..., None])[:, :m]
    return out.to(torch.bfloat16)


def kernel_round(x):
    """fp32 ``x`` (an even last axis) rounded to bf16 as ``sbf16_hopper``
    rounds scores: pairs (2i, 2i + 1) packed by ``cvt.rn.bf16x2.f32``
    (round to nearest even: the bits plus 0x7FFF plus the kept lsb, cut to
    16), element 2i in the low half, then the halves shifted back
    (``w << 16``, ``w & 0xFFFF0000``)."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    half = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) & 0xFFFF
    w = half[..., 0::2] | (half[..., 1::2] << 16)
    lo, hi = (w << 16) & 0xFFFFFFFF, w & 0xFFFF0000
    out = torch.stack([lo, hi], dim=-1).flatten(-2)
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32).view(torch.float32)


NEG_BF16 = float.fromhex("-0x1.94p+99")  # the kernel's kNegBf16


def emulate_sbf16(q, k, v, heads, fast, ceiling, mutant=None):
    """``sbf16_hopper``'s plan: 64-key tiles to round_up(n, 128) of
    zero-filled keys, the mask (keys ≥ n at bf16(−1e30)) on the tiles from
    n // 64 on (none for ``ceiling``); exact mode's pass 1 takes the max of
    the fp32 scores over the valid keys and rounds it once, pass 2 rounds
    each score, masks, rounds s − m and takes ``exp2_poly``; P rounded to
    bf16 before P·V, l the fp32 sum of p (``ceiling``: p = s, l = n_pad).
    Every query row's plan is its own, so all rows go at once.  Mutants:
    ``running_max`` (the max of the tiles seen so far, no rescale) and
    ``unmasked``."""
    b, n, hd = q.shape
    exact = not fast and not ceiling
    c = torch.tensor(SCALE * av.LOG2E, dtype=torch.float32)
    qp, kp, vp, n_pad = _operands(q, k, v, _round_up(n, 16))
    tiles = n_pad // 64
    masked_from = tiles if ceiling or mutant == "unmasked" else n // 64
    out = torch.zeros(b, n, hd)
    for h in range(heads):
        cols = slice(h * 64, (h + 1) * 64)
        qs = _bf16(qp[..., cols] * c)
        s = [qs @ kp[:, j * 64:(j + 1) * 64, cols].mT for j in range(tiles)]
        valid = [torch.arange(j * 64, (j + 1) * 64) < n if j >= masked_from else None
                 for j in range(tiles)]
        m = torch.full((b, qs.shape[1], 1), -math.inf)
        if exact:  # pass 1
            running = []
            for j in range(tiles):
                sj = s[j] if valid[j] is None else torch.where(valid[j], s[j], -math.inf)
                m = torch.maximum(m, sj.amax(-1, keepdim=True))
                running.append(_bf16(m))
            m = _bf16(m)
        acc = torch.zeros(b, qs.shape[1], 64)
        l = torch.zeros(b, qs.shape[1], 1)
        for j in range(tiles):  # pass 2
            if ceiling:
                p = s[j]
            else:
                x = kernel_round(s[j])
                if valid[j] is not None:
                    x = torch.where(valid[j], x, NEG_BF16)
                if exact:
                    x = kernel_round(x - (running[j] if mutant == "running_max" else m))
                p = kernel_exp2(x)
                l = l + p.sum(-1, keepdim=True)
            acc = acc + _bf16(p) @ vp[:, j * 64:(j + 1) * 64, cols]
        out[..., cols] = (acc / (float(n_pad) if ceiling else l))[:, :n]
    return out.to(torch.bfloat16)


def emulate(variant, q, k, v, heads, mutant=None):
    kind, arg = av.parse_variant(variant, q.shape[1])
    if kind == "ilv":
        return emulate_ilv(q, k, v, heads, arg, mutant)
    if kind == "sbf16":
        return emulate_sbf16(q, k, v, heads, *arg, mutant=mutant)
    return emulate_chunk(q, k, v, heads, arg, mutant)


def _inputs(n, heads, seed, qk_std=0.5):
    """The probe script's inputs (bench_spatial_variants.py:250-252): q, k
    at std 0.5 (or ``qk_std``), v at 1, bf16, batch 2."""
    rng = np.random.RandomState(seed)
    return [torch.from_numpy((rng.randn(2, n, heads * 64) * s).astype(np.float32))
            .to(torch.bfloat16) for s in (qk_std, qk_std, 1.0)]


def _run_variant(bsv, variant, q, k, v, heads):
    out = bsv.run_variant(variant, *(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                                      for t in (q, k, v)),
                          scale=SCALE, n_valid=q.shape[1], num_heads=heads)
    return torch.from_numpy(np.asarray(out, np.float32))


def _rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def _cases():
    out = []
    for n in (40, 64, 200):
        for heads in (2, 4):
            for variant in ("ilv", "nomask", "chunk1", "chunk2", "chunk4"):
                try:
                    av.parse_variant(variant, n)
                except ValueError:  # outside the JAX domain: chunk4 at n = 40 and 200
                    continue
                out.append((variant, n, heads))
    # sbf16: a ragged tile and a tile of pad keys (300: 44 real keys in tile 4,
    # none in tile 5), and the probe shape's 22 tiles
    out += [(variant, n, heads) for n in (300, 1370) for heads in (2, 6)
            for variant in ("sbf16", "sbf16:fast", "ceiling")]
    return out


def test_kernel_exp2_is_exp2_poly():
    """The kernels' floor and clamps give exp2_poly's bits over [−300, 140]
    (x < −126 gives 0 both ways; x ≥ 128 keeps the exponent at 127)."""
    x = np.concatenate([np.linspace(-300, 140, 40009, dtype=np.float32),
                        np.float32([-200, -127.5, -127, -126.5, -126, -1, -0.0, 0, 1, 126.5,
                                    127, 127.75, 128, 130.25])])
    t = torch.from_numpy(x)
    assert torch.equal(kernel_exp2(t), av.exp2_poly(t))


@pytest.mark.parametrize("variant,n,heads", _cases())
def test_tiling_matches_run_variant(bsv, variant, n, heads):
    q, k, v = _inputs(n, heads, seed=n + heads)
    want = _run_variant(bsv, variant, q, k, v, heads)
    got = emulate(variant, q, k, v, heads)
    assert got.shape == want.shape
    assert _rel(got, want) <= TOL


# (variant, mutant): each wrong plan misses the TPU kernel by more than the
# card's tolerance.  Peaked inputs (q, k at std 4: scaled logits up to ~90)
# make the bf16 rounding point of q·c matter.
MUTANTS = [("chunk2", "p_other_slot"), ("chunk2", "output_other_head"),
           ("chunk2", "q_scaled_after_rounding"), ("ilv", "q_scaled_after_rounding")]


_MUTANT_WANT = {}  # (variant, qk_std) → run_variant's output, shared by that variant's mutants


def _check_mutant(bsv, variant, mutant, qk_std):
    n, heads = 200, 2
    q, k, v = _inputs(n, heads, seed=7, qk_std=qk_std)
    if (variant, qk_std) not in _MUTANT_WANT:
        _MUTANT_WANT[variant, qk_std] = _run_variant(bsv, variant, q, k, v, heads)
    want = _MUTANT_WANT[variant, qk_std]
    assert _rel(emulate(variant, q, k, v, heads), want) <= TOL
    assert _rel(emulate(variant, q, k, v, heads, mutant), want) > chip_smoke.ATTN_TOL


@pytest.mark.parametrize("variant,mutant", MUTANTS)
def test_mutant_misses_run_variant(bsv, variant, mutant):
    _check_mutant(bsv, variant, mutant, 4.0)


# sbf16's mutants: a running max (of the tiles seen so far, no rescale) in
# place of the global one, on the peaked inputs; the mask dropped on the
# probe script's inputs, where a zero pad key's p = exp2(-m) is not small.
SBF16_MUTANTS = [("sbf16", "running_max", 4.0), ("sbf16", "unmasked", 0.5),
                 ("sbf16:fast", "unmasked", 0.5)]


@pytest.mark.parametrize("variant,mutant,qk_std", SBF16_MUTANTS)
def test_sbf16_mutant_misses_run_variant(bsv, variant, mutant, qk_std):
    _check_mutant(bsv, variant, mutant, qk_std)


def test_kernel_score_rounding_is_torch_bf16():
    """``sbf16_hopper``'s rounding of a score gives torch's bf16 bits on
    seeded scores, on exact ties between two bf16 values (both parities of
    the kept bit), on signed zeros, subnormals, values that round to ±inf,
    and on bf16(−1e30), the mask value."""
    rng = np.random.RandomState(5)
    base = rng.randint(0, 2**16, 4096).astype(np.int64) << 16  # bf16 bit patterns
    ties = (base | 0x8000) & 0xFFFFFFFF                          # halfway above each
    near = (base + rng.randint(-0x8000, 0x8000, 4096)) & 0xFFFFFFFF
    special = np.array([0x00000000, 0x80000000, 0x00000001, 0x00018000, 0x807F8000,
                        0x7F7F8000, 0xFF7FFFFF, 0x7F7F7FFF, 0x3F808000, 0x3F818000,
                        np.float32(-1e30).view(np.uint32)], np.int64)
    bits = np.concatenate([ties, near, special, special[:1]])
    x = np.where(bits >= 2**31, bits - 2**32, bits).astype(np.int32).view(np.float32)
    x = x[np.isfinite(x)]
    x = np.concatenate([x, (rng.randn(4096) * 40).astype(np.float32)])
    x = torch.from_numpy(x[: len(x) // 2 * 2].copy())
    got = kernel_round(x)
    want = x.to(torch.bfloat16).float()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert kernel_round(torch.tensor([-1e30, -1e30])).tolist() == [NEG_BF16, NEG_BF16]


def test_launch_checks_tensor_maps_before_any_build():
    """The Hopper launches check each operand's tensor map first: a base
    that is not 16-byte aligned raises before anything is built."""
    n, heads = 40, 2
    flat = torch.zeros(3 * 2 * n * heads * 64 + 1, dtype=torch.bfloat16)
    q, k, v = (flat[1 + i * 2 * n * heads * 64:1 + (i + 1) * 2 * n * heads * 64]
               .view(2, n, heads * 64) for i in range(3))
    for name in ("ilv", "chunk"):
        with pytest.raises(ValueError, match="16-byte aligned"):
            av._launch_spatial(name, q, k, v, SCALE, heads, 0, 0)


def test_split_rewrites_find_their_anchors():
    """``bench_probe_split``'s rewrites of this tree's sources (the split
    builds of the Hopper probes, ``sbf16`` among them, of the chain probe,
    of Kernel A's wide forward, and the clock64 timeline) each find their
    anchor once, and it finds Kernel A's D = 192 forward to time and both
    wide kinds in the wide kernel's source; ``bench_resize_conv`` finds the
    Hopper resize -> conv, whose split builds are in its source."""
    from video_depth_anything_torch import bench_probe_split as bps
    from video_depth_anything_torch import bench_resize_conv as brc

    designs = {d["name"]: (d, csrc, kinds) for d, csrc, kinds in bps.designs_of(str(ROOT))}
    assert set(designs) == {"hopper", "chain-hopper", "flash", "wide-hopper"}
    design, csrc, kinds = designs["hopper"]
    assert kinds == ("ilv", "chunk", "sbf16")
    text = (Path(csrc) / design["file"]).read_text()
    assert bps.rewrite(text, design, kinds).count("PROBE_STOP") >= 5
    chain, _, chain_kinds = designs["chain-hopper"]
    assert chain_kinds == ("chain",)
    assert bps.rewrite(text, chain, chain_kinds).count("PROBE_STOP") >= 4
    assert [bps.kind_of(f"chain:{m}") for m in av.CHAIN_MODES] == ["chain"] * 7
    rc_src = Path(csrc) / "resize_conv.cu"
    assert brc.design_of(str(rc_src.parent)) is brc.HOPPER
    assert "RC_STOP" in rc_src.read_text()
    assert all(text.count(anchor) == 1 for anchor, _ in bps.TIMELINE)
    assert designs["flash"][2] == ("flash192",)
    wide, wide_csrc, wide_kinds = designs["wide-hopper"]
    assert wide_kinds == bps.WIDE_KINDS
    wide_text = (Path(wide_csrc) / wide["file"]).read_text()
    assert bps.rewrite(wide_text, wide, wide_kinds).count("PROBE_STOP") == 7  # 5 + 2 defines
    assert [bps.kind_of(v) for v in ("wide", "wide:fast", "wide_f32", "wide_f32:fast")] == \
        ["wide", "wide", "wide_f32", "wide_f32"]


def test_chain_mix_cancels_unrolling():
    """The chain-free build's counts are scaled to the full build's number
    of products before they are subtracted, and P's pack is added."""
    from collections import Counter

    from video_depth_anything_torch import bench_probe_split as bps

    full = Counter({"HGMMA.64": 32, "FADD.RM": 128, "FFMA": 600, "MOV": 40})
    nochain = Counter({"HGMMA.64": 16, "FFMA": 44, "MOV": 20})
    mix = bps.chain_mix(full, nochain)
    assert mix["exponentials_in_sass"] == 128 and mix["products_ratio"] == 2.0
    assert mix["per_score"]["FFMA"] == pytest.approx((600 - 88) / 128, abs=1e-3)
    assert "MOV" not in mix["per_score"]
    assert mix["per_score_by_class"]["conversion"] == 0.5
    total = mix["per_score_by_class"]["total"]
    assert bps.chain_bound_ms(mix["per_score_by_class"], 1e9, 132, 1.98e9) == \
        pytest.approx(1e9 * total / 128 / (132 * 1.98e9) * 1e3)


# ---- the softmax-chain probe: chain_hopper<MODE> ----
CHAIN_STAGES = 6


def _chain_p(mode, s, m):
    """kern's chain on fp32 scores ``s`` (already bf16-rounded for bf16s
    and bf16x) as the kernel computes it; m the row max where the mode
    takes one."""
    if mode == "gemms":
        return s
    if mode == "exact":
        return torch.exp(s - m)
    if mode == "sexp":
        return av.schraudolph_exp2(s)
    if mode == "pexp":
        return av.cubic_exp2(s)
    if mode == "bf16x":
        return torch.exp2(_bf16(s - m))
    return torch.exp2(s)  # exp, bf16s


def emulate_chain(mode, q, k, v, mutant=None):
    """``chain_hopper``'s result on q (BH, Nq, 64), k (BH, Nk, 64), v (BH,
    Nk, Dv), bf16.  Under ``online_max`` ``bf16x`` skips its first pass
    and takes the max of the tiles seen so far (no rescale); under
    ``v_stage_without_pass1`` pass 2 reads tile j's V from ring stage
    j % 6 in place of (pass 1's loads + j) % 6; under ``early_release``
    a stage goes back once S of its tile is issued, so that the load six
    on lands before P·V reads the V it held."""
    bh, nq, d = q.shape
    nk = k.shape[1]
    tiles = nk // 64
    blocks = -(-nq // 128)
    qp = F.pad(q.float(), (0, 0, 0, blocks * 128 - nq))  # TMA's zero fill
    kf, vf = k.float(), v[..., :64].float()
    two_pass = mode == "bf16x" and mutant != "online_max"
    pass1 = two_pass * tiles
    # the ring's loads: pass 1's K tiles, then pass 2's K and V tiles
    loads = [("k", j) for j in range(pass1)] + [("kv", j) for j in range(tiles)]
    stage = torch.zeros(CHAIN_STAGES, 2, bh, 64, 64)  # the ring (K, V)
    views = []  # what each stage holds once load g has landed
    for g, (kind, j) in enumerate(loads):
        st = stage[g % CHAIN_STAGES]
        st[0] = kf[:, j * 64:(j + 1) * 64]
        if kind == "kv":
            st[1] = vf[:, j * 64:(j + 1) * 64]
        views.append(stage.clone())

    def kv_of(j):  # K and V of pass 2's tile j as its products read them
        g = pass1 + j
        kt = views[g][g % CHAIN_STAGES][0]
        vg = g if mutant != "early_release" else min(g + CHAIN_STAGES, len(loads) - 1)
        vs = g % CHAIN_STAGES if mutant != "v_stage_without_pass1" else j % CHAIN_STAGES
        return kt, views[vg][vs][1]

    out = torch.zeros(bh, blocks * 128, 64)
    for x in range(blocks):
        for cw in range(2):  # the consumer warpgroups' 64 rows each
            r0 = x * 128 + cw * 64
            qs = qp[:, r0:r0 + 64]
            m = torch.full((bh, 64, 1), -math.inf)
            if two_pass:  # the global max of the fp32 scores, rounded once
                for g in range(pass1):
                    m = torch.maximum(m, (qs @ views[g][g % CHAIN_STAGES][0].mT)
                                      .amax(-1, keepdim=True))
                m = _bf16(m)
            acc = torch.zeros(bh, 64, 64)
            for j in range(tiles):
                kt, vt = kv_of(j)
                s = qs @ kt.mT
                if mode in ("bf16s", "bf16x"):
                    s = _bf16(s)
                if mode == "exact":  # online max and rescale
                    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                    acc = acc * torch.exp(m - m_new)
                    m = m_new
                elif mutant == "online_max":
                    m = torch.maximum(m, s.amax(-1, keepdim=True))
                acc = acc + _bf16(_chain_p(mode, s, m)) @ vt
            out[:, r0:r0 + 64] = acc
    return out[:, :nq].to(torch.bfloat16)


def _chain_inputs(bh, nq, nk, seed):
    """The chain script's inputs (bench_softmax_chain.py:48-51): q, k at std
    0.35, v at 1 and 128 wide, bf16."""
    rng = np.random.RandomState(seed)
    return [torch.from_numpy((rng.randn(*shape) * std).astype(np.float32)).to(torch.bfloat16)
            for shape, std in (((bh, nq, 64), 0.35), ((bh, nk, 64), 0.35), ((bh, nk, 128), 1.0))]


@functools.lru_cache(maxsize=None)
def _kern_case(mode, nq, nk, seed):
    """``kern`` on ``_chain_inputs(2, nq, nk, seed)``, computed once."""
    return _kern(mode, *_chain_inputs(2, nq, nk, seed))


def _kern(mode, q, k, v):
    """The TPU kernel ``kern`` in interpret mode, one batch-head a grid step."""
    bh, nq, d = q.shape
    nk, dv = v.shape[1:]
    out = pl.pallas_call(
        chain_kern(mode, d), grid=(bh,),
        in_specs=[pl.BlockSpec((1, nq, d), lambda b: (b, 0, 0)),
                  pl.BlockSpec((1, nk, d), lambda b: (b, 0, 0)),
                  pl.BlockSpec((1, nk, dv), lambda b: (b, 0, 0))],
        out_specs=pl.BlockSpec((1, nq, d), lambda b: (b, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((bh, nq, d), jnp.bfloat16), interpret=True)(
            *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)))
    return torch.from_numpy(np.asarray(out, np.float32))


# The plan against kern: 2 bf16 ulps of max|output| (fp32 sums in another
# order, the same rounding points), except where kern's chain runs on bf16
# scores: on the CPU, XLA evaluates its bf16 exp2 (and bf16x's s - m) with
# bf16 intermediates, one bf16 ulp of p or more from the fp32 exp2 rounded
# once that the TPU kernel's rounding points and the port's plain version
# define; the plain version itself is 1.1e-2 of max|output| from kern at
# Nq = 300, Nk = 128 (bf16s), so those modes are held to 1.5e-2, and the
# plan to the plain version within 2 ulps.
CHAIN_KERN_TOL = {m: 1.5e-2 if m in ("bf16s", "bf16x") else TOL for m in av.CHAIN_MODES}

# Nq = 100: one query block; 300: three blocks with a partial last one;
# Nk = 128, 384 and 640: 2, 6 and 10 key tiles (the ring wraps in pass 2)
@pytest.mark.parametrize("nq,nk", [(100, 128), (100, 384), (300, 128), (300, 384), (300, 640)])
@pytest.mark.parametrize("mode", av.CHAIN_MODES)
def test_chain_tiling_matches_kern(mode, nq, nk):
    q, k, v = _chain_inputs(2, nq, nk, seed=nq + nk)
    want = _kern_case(mode, nq, nk, nq + nk)
    got = emulate_chain(mode, q, k, v)
    assert got.shape == want.shape
    assert _rel(got, want) <= CHAIN_KERN_TOL[mode]
    # the port's plain version defines the numerics: the plan meets it closely
    assert _rel(got, av.softmax_chain_plain(mode, q, k, v)) <= TOL


# each mutant at a shape where it changes what the products read
@pytest.mark.parametrize("mode,mutant,nk", [("bf16x", "online_max", 384),
                                            ("bf16x", "v_stage_without_pass1", 128),
                                            ("exp", "early_release", 640),
                                            ("bf16x", "early_release", 640)])
def test_chain_mutant_misses_kern(mode, mutant, nk):
    q, k, v = _chain_inputs(2, 300, nk, seed=11)
    want = _kern_case(mode, 300, nk, 11)
    assert _rel(emulate_chain(mode, q, k, v), want) <= CHAIN_KERN_TOL[mode]
    assert _rel(emulate_chain(mode, q, k, v, mutant), want) > CHAIN_KERN_TOL[mode]
    assert _rel(emulate_chain(mode, q, k, v, mutant), want) > chip_smoke.CHAIN_TOL
