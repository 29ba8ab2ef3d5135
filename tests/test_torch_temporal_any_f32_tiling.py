"""The plan of the fp32 run-time-d Kernel B (``csrc/temporal_attention_any_f32.cu``,
``ops/temporal_attention.any_f32_plan``), emulated in torch on the CPU,
against the JAX Pallas temporal kernel run as the JAX package's tests run
it (interpret mode) and against the port's plain version.

``any_f32_kernel`` follows the plan step by step: the persistent walk over
``tile_plan``'s tiles (one location a tile where the tiles would not cover
the SMs), the loader (TMA boxes of ``bw`` floats, ``nb`` a row from column
b·w, zeros past the tensor's end; or the cp.async runs of a tile's
contiguous floats), slots whose rows past T hold garbage (NaN here)
except v's, zeroed once; the units and lane split of the width class
(class 0: a lane a whole query row; classes 1-3: KL lanes a query row,
lane c holding keys c + KL·j), the sums in the kernel's order (scores
column by column, each lane's exponentials and P·V over its keys in j
order, then the xor-tree over the row's lanes), and the P·V passes of DC
columns through each box, storing only the columns a pass covers (the
output starts as NaN, so a column no pass stores shows).  Its wrong plans
(a lane's key block shifted by one frame, the last box of a wide row never
loaded, the softmax normalised over one lane's keys) each miss the plain
version by more than ``F32_TOL``.  A pure test plans every shape the JAX
gate admits off the six instantiated widths."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from video_depth_anything_torch.ops import flash_attention as t_flash
from video_depth_anything_torch.ops import temporal_attention as t_temporal
from video_depth_anything_tpu.ops.pallas_temporal import temporal_attention_window
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LOG2E = 1.0 / math.log(2.0)
KT = 32  # frame rows a slot holds
SMEM_MAX = 227 * 1024
MUTANTS = ("key_block_shifted", "last_box_dropped", "lane_softmax")


def _load_slot(x, bi, t, s0, c0, lv, plan, c, mutant):
    """One tensor's slot rows of a tile, ``(nb, 32, bw)`` floats, as the
    plan's loader leaves them (rows past T and columns no copy writes:
    NaN)."""
    nb, bw, w = plan["nb"], plan["bw"], plan["w"]
    rows = torch.full((nb, KT, bw), math.nan)
    frames = x[bi].reshape(t, -1)  # (T, S·C): the frame rows the loaders read
    start = s0 * c + c0
    if plan["loader"] == "tma":
        padded = torch.cat([frames, torch.zeros(t, nb * w + bw)], dim=1)  # zeros past the end
        for bx in range(nb):
            if mutant == "last_box_dropped" and bx == nb - 1:
                rows[bx, :t] = 0.0  # never loaded: the previous tile's (here zero) rows
                continue
            rows[bx, :t] = padded[:, start + bx * w:start + bx * w + bw]
    else:  # cp.async: one run a frame (every head), or one a (frame, location)
        cg = plan["group"] * (c // plan["heads"])
        runs = [(0, lv * c)] if cg == c else [(l * c, cg) for l in range(lv)]
        for l, (off, n) in enumerate(runs):
            dst = 0 if cg == c else l * cg
            rows[0, :t, dst:dst + n] = frames[:, start + off:start + off + n]
    return rows


def _columns(rows, plan, col, d):
    """A head's d columns of every slot row, read box by box."""
    nb, w = plan["nb"], plan["w"]
    if nb == 1:
        return rows[0, :, col:col + d]
    assert col == 0  # several boxes: one head a tile
    return torch.cat([rows[bx, :, :min(d - bx * w, w)] for bx in range(nb)], dim=1)


def _tree(parts):
    """The xor-tree sum over a row's lanes (rounds 1, 2, 4): ((p0 + p1) +
    (p2 + p3)) + ..., the same value on every lane."""
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
    return parts[0]


def _attend_head(qh, kh, vh, t, sl2, plan, mutant):
    """``(32, d)`` slot columns of one (location, head) → its ``(32, d)``
    output rows (rows past T garbage), in the width class's order."""
    d = qh.shape[1]
    keys = torch.arange(KT)
    kl = plan["kl"]
    if mutant == "key_block_shifted":  # each lane scores its keys one frame on (mod T)
        kh = kh[[(f + 1) % t if f < t else f for f in range(KT)]]
    scores = torch.zeros(KT, KT)
    for e in range(d):  # the kernel's column order
        scores = scores + qh[:, e:e + 1] * kh[:, e][None, :]
    scores = torch.where(keys[None, :] < t, scores, torch.tensor(-math.inf))
    if kl == 1:  # class 0: a lane's whole row
        m = scores.amax(-1, keepdim=True)
        p = torch.exp2(scores * sl2 - m * sl2)
        l = torch.zeros(KT, 1)
        for f in range(KT):
            l = l + p[:, f:f + 1]
        p = p * (1.0 / l)
        o = torch.zeros(KT, d)
        for f in range(KT):
            o = o + p[:, f:f + 1] * vh[f][None, :]
        return o
    lanes = [keys[c::kl] for c in range(kl)]  # lane c's keys c + KL·j
    m_lane = [scores[:, ks].amax(-1, keepdim=True) for ks in lanes]
    m = torch.stack(m_lane).amax(0)
    ps, ls = [], []
    for c, ks in enumerate(lanes):
        mc = m_lane[c] if mutant == "lane_softmax" else m
        pc = torch.exp2(scores[:, ks] * sl2 - mc * sl2)
        lc = torch.zeros(KT, 1)
        for j in range(len(ks)):
            lc = lc + pc[:, j:j + 1]
        ps.append(pc)
        ls.append(lc)
    total = _tree(ls)
    parts = []
    for c, ks in enumerate(lanes):
        pc = ps[c] * (1.0 / (ls[c] if mutant == "lane_softmax" else total))
        oc = torch.zeros(KT, d)
        for j, f in enumerate(ks.tolist()):
            oc = oc + pc[:, j:j + 1] * vh[f][None, :]
        parts.append(oc)
    return _tree(parts)


def _stored_columns(plan, d):
    """The head columns the P·V passes store: DC-column passes through each
    box, the last of a box masked to the box's columns."""
    if plan["kl"] == 1:
        return list(range(d))
    cols = []
    for bx in range(plan["nb"]):
        e1 = min(d - bx * plan["w"], plan["w"])
        for dc0 in range(0, e1, plan["dc"]):
            cols += [bx * plan["w"] + x for x in range(dc0, min(dc0 + plan["dc"], e1))]
    return cols


def any_f32_kernel(q, k, v, heads, scale, sms=t_temporal.SMS, mutant=None):
    """``(B, T, S, C)`` fp32 → ``(B, T, S, C)`` in the plan of
    ``any_f32_plan`` (``mutant``: one of MUTANTS)."""
    b, t, s, c = q.shape
    d = c // heads
    plan = {**t_temporal.any_f32_plan(q.shape, heads, sms), "heads": heads}
    assert plan["smem"] is not None
    locs, group = plan["locs"], plan["group"]
    cg, hgroups, sblocks = group * d, heads // group, -(-s // locs)
    sl2 = scale * LOG2E
    cols = torch.tensor(_stored_columns(plan, d))
    out = torch.full((b, t, s, c), math.nan)
    for tile in range(plan["tiles"]):  # head group fastest
        hg, r = tile % hgroups, tile // hgroups
        sb, bi = r % sblocks, r // sblocks
        s0, c0 = sb * locs, hg * cg
        lv = min(locs, s - s0)
        slots = [_load_slot(x, bi, t, s0, c0, lv, plan, c, mutant) for x in (q, k, v)]
        slots[2][:, t:] = 0.0  # v's rows past T, zeroed once
        for l in range(lv):
            for h in range(group):
                col = l * cg + h * d
                qh, kh, vh = (_columns(x, plan, col, d) for x in slots)
                o = _attend_head(qh, kh, vh, t, sl2, plan, mutant)
                out[bi, :, s0 + l, c0 + h * d + cols] = o[:t, cols]
    return out


# (heads, d, T, S, B): a case for each class, loader and box layout; their
# interpret-mode references are computed once and shared
CASES = {"d96_h4_T17": (4, 96, 17, 5, 2), "d5_h8": (8, 5, 32, 7, 1), "d3_h16_T8": (16, 3, 8, 9, 2),
         "c5_h1_cp_async": (1, 5, 32, 9, 1), "d320_h1_boxes": (1, 320, 32, 3, 1),
         "d512_h1_class4": (1, 512, 32, 2, 1)}
_refs = {}


def _case(name):
    """Inputs (numpy, seeded) and the JAX kernel's output in interpret mode."""
    if name not in _refs:
        heads, d, t, s, b = CASES[name]
        c = heads * d
        rng = np.random.RandomState(c + t + s)
        q, k = (rng.randn(b, t, s, c).astype(np.float32) * 1.6 for _ in range(2))
        v = rng.randn(b, t, s, c).astype(np.float32)
        want = np.array(temporal_attention_window(*(jnp.asarray(x) for x in (q, k, v)),
                                                    heads=heads, scale=d**-0.5, interpret=True))
        _refs[name] = (q, k, v, want)
    return _refs[name]


def test_cases_exercise_the_plan():
    """The cases reach every class, both loaders, both ring layouts and
    several boxes a row."""
    plans = {n: t_temporal.any_f32_plan((b, t, s, h * d), h)
             for n, (h, d, t, s, b) in CASES.items()}
    assert plans["d96_h4_T17"]["kind"] == 3 and plans["d5_h8"]["kind"] == 1
    assert plans["d3_h16_T8"]["kind"] == 0 and plans["d3_h16_T8"]["tp"] == 8
    assert plans["c5_h1_cp_async"]["loader"] == "cp.async"
    assert plans["d320_h1_boxes"]["nb"] == 2 and plans["d320_h1_boxes"]["slots"] == 2
    assert plans["d320_h1_boxes"]["split"] and plans["d320_h1_boxes"]["kind"] == 3
    p512 = plans["d512_h1_class4"]
    assert p512["split"] and p512["kind"] == 4 and p512["nb"] == 3 and p512["nw"] == 8
    assert p512["slots"] == 3 and p512["dc"] == 32
    assert not any(plans[n]["split"]
                   for n in ("d96_h4_T17", "d5_h8", "d3_h16_T8", "c5_h1_cp_async"))
    assert all(p["loader"] == "tma" for n, p in plans.items() if n != "c5_h1_cp_async")
    for n, (h, d, t, s, b) in CASES.items():
        assert not t_temporal.instantiated(h * d, h), n
        assert t_temporal.temporal_gate((b, max(t, 8), s, h * d), h, auto=False), n


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_matches_jax_kernel_and_plain(name):
    heads, d, _, _, _ = CASES[name]
    q, k, v, want = _case(name)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = any_f32_kernel(tq, tk, tv, heads, d**-0.5)
    assert torch.isfinite(got).all()
    plain = t_temporal.temporal_attention_plain(tq, tk, tv, heads, d**-0.5)
    assert chip_smoke.rel_err(got, plain) <= chip_smoke.F32_TOL / 10
    assert chip_smoke.rel_err(got, torch.from_numpy(want)) <= chip_smoke.F32_TOL


@pytest.mark.parametrize("mutant,name", [("key_block_shifted", "d96_h4_T17"),
                                         ("key_block_shifted", "d3_h16_T8"),
                                         ("last_box_dropped", "d320_h1_boxes"),
                                         ("lane_softmax", "d5_h8"),
                                         ("lane_softmax", "d96_h4_T17")])
def test_wrong_plans_are_caught(mutant, name):
    """Each wrong plan, made by the emulation itself, misses the plain
    version by more than F32_TOL (as chip_smoke's estimate of the dropped
    box does)."""
    heads, d, _, _, _ = CASES[name]
    q, k, v, _ = _case(name)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    plain = t_temporal.temporal_attention_plain(tq, tk, tv, heads, d**-0.5)
    got = any_f32_kernel(tq, tk, tv, heads, d**-0.5, mutant=mutant)
    assert torch.isfinite(got).all()
    assert chip_smoke.rel_err(got, plain) > chip_smoke.F32_TOL
    if mutant == "last_box_dropped":  # and chip_smoke's estimate of it
        w = t_temporal.any_f32_plan(tq.shape, heads)["w"]
        assert chip_smoke.rel_err(chip_smoke.last_box_plain(tq, tk, tv, heads, d**-0.5, w),
                                  plain) > chip_smoke.F32_TOL


@pytest.mark.parametrize("name,locs", [("d5_h8", 3), ("c5_h1_cp_async", 25)])
def test_small_batch_takes_one_location_a_tile(name, locs):
    """Where tile_plan's tiles would not cover the SMs, a tile is one
    location; on a card of one SM the same shapes keep tile_plan's
    locations (a cp.async tile then copies one run of 9 locations' floats a
    frame), and the emulation computes the same either way."""
    heads, d, t, s, b = CASES[name]
    shape = (b, t, s, heads * d)
    assert t_temporal.any_f32_plan(shape, heads)["locs"] == 1
    assert t_temporal.any_f32_plan(shape, heads, sms=1)["locs"] == locs
    q, k, v, _ = _case(name)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    torch.testing.assert_close(any_f32_kernel(tq, tk, tv, heads, d**-0.5, sms=1),
                               any_f32_kernel(tq, tk, tv, heads, d**-0.5), rtol=1e-6, atol=1e-6)


def _admitted():
    """(C, heads, T) the JAX gate admits (under ``pallas``, a superset of
    ``auto``) off the six instantiated widths, C ≤ 2048."""
    return [(c, h, t) for h in (1, 2, 4, 8, 16) for t in (8, 16, 24, 32) for c in range(1, 2049)
            if t_temporal.temporal_gate((1, t, 1, c), h, auto=False)
            and not t_temporal.instantiated(c, h)]


@pytest.mark.parametrize("s", [5476, 361, 1, 7])
def test_every_admitted_shape_has_a_plan(s):
    """Every gate-admitted shape off the six widths has a plan within
    227 KB that names its loader; the TMA loader only where
    ``ops/flash_attention.tma_geometry``'s rules (16-byte strides and base)
    hold for the (B, T, 1, S·C) view the tensor map reads and every box of
    every tile starts on a 16-byte boundary (the plan asks C and G·d to be
    multiples of 4, else cp.async); a box ≤ 256
    floats, bw / 4 odd, the boxes covering the row; and ``kernel_takes``."""
    admitted = _admitted()
    assert len(admitted) == 95 * 4  # 95 (C, heads), each at four T
    for c, h, t in admitted:
        for b in (1, 4):
            plan = t_temporal.any_f32_plan((b, t, s, c), h)
            assert plan["smem"] is not None and plan["smem"] <= SMEM_MAX, (c, h, t, s)
            assert plan["loader"] in ("tma", "cp.async")
            # the map's (B, T, 1, S·C) view: rows of S·C floats, a frame apart
            view = torch.empty((b, t, 1, s * c), device="meta")
            try:
                t_flash.tma_geometry(view)
                tma_ok = True
            except ValueError:
                tma_ok = False
            cg, locs = plan["group"] * (c // h), plan["locs"]
            starts = {(s0 * c + hg * cg + bx * plan["w"]) % 4 for s0 in range(0, s, locs)
                      for hg in range(h // plan["group"]) for bx in range(plan["nb"])}
            assert (plan["loader"] == "tma") == (c % 4 == 0 and cg % 4 == 0), (c, h, t, s)
            assert plan["loader"] != "tma" or (tma_ok and starts == {0}), (c, h, t, s)
            assert plan["bw"] <= 256 and plan["bw"] % 4 == 0 and (plan["bw"] // 4) % 2 == 1
            assert plan["nb"] * plan["w"] >= plan["row"]
            assert plan["nb"] == 1 or plan["w"] % 16 == 0
            if plan["split"]:  # a slot a tensor: three a tile, or two for one unit a warp
                assert plan["kind"] >= 3 and plan["nb"] * plan["bw"] > 148
                assert plan["slots"] >= 3 or (plan["loader"] == "tma"
                                              and plan["units"] <= plan["nw"])
                assert plan["loader"] == "tma" or plan["slots"] % 3 == 0
            else:  # a slot a tile
                assert plan["slots"] in (2, 4)
            assert plan["nw"] <= (16 if plan["kind"] == 0 else 8)
            assert t_temporal.kernel_takes((b, t, s, c), h, torch.float32)


def test_plan_source_constants():
    """The kernel source and ``any_f32_plan`` agree on the geometry's
    constants: 32 frame rows a slot, at most twelve slots and eight consumer
    warps (sixteen in class 0), boxes of at most 256 elements, 227 KB a CTA."""
    import re
    from pathlib import Path

    csrc = Path(t_temporal.__file__).parent.parent / "csrc"
    src = (csrc / "temporal_attention_any_f32.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", src))
    assert consts["kT"] == "32" and consts["kMaxSlots"] == str(t_temporal._MAX_SLOTS)
    assert consts["kMaxWarps"] == "8"
    assert consts["kMaxRowWarps"] == "16"
    assert consts["kBoxMax"] == "256" and consts["kSmemMax"] == "227 * 1024"
    assert int(consts["kSmSmem"]) == t_temporal._SM_SMEM
    assert consts["kBarBytes"] == "2 * kMaxSlots * 8"
