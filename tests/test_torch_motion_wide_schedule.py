"""The persistent tile walk of Kernel C's wide chain
(``csrc/motion_module_wide.cu``): ``ops/motion_module.wide_tile`` and
``wide_schedule`` (pure, no card) visit every output tile of a product
exactly once, in the grouped order the source's ``tile_coords`` computes,
at the six shipped shapes' products and at ragged M and N from the domain's
C = 8 up to 1920; the source's constants (rows a tile, row blocks a group,
the tile width rule) are the host's."""

import re
from pathlib import Path

import pytest
import torch

from video_depth_anything_torch.ops import motion_module as t_motion
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SOURCE = Path(t_motion.__file__).resolve().parent.parent / "csrc" / "motion_module_wide.cu"
BM, GROUP = t_motion.WIDE_BM, t_motion.WIDE_GROUP_M


def grouped_order(nm: int, nn: int) -> list:
    """The walk written out: groups of GROUP row blocks, column after column
    within a group, the group's rows within a column."""
    out = []
    for first in range(0, nm, GROUP):
        rows = range(first, min(first + GROUP, nm))
        out += [(mb, nb) for nb in range(nn) for mb in rows]
    return out


def products(m: int, c: int, dtype=torch.bfloat16, ff: int = 4) -> list:
    """(M, N, BN) of a module's products at width C (GEGLU's N = 2F)."""
    f = t_motion._round_up(ff * c, 64)
    f = t_motion._round_up(f, t_motion.wide_bn(2 * f, dtype) // 2)
    return [(m, n, t_motion.wide_bn(n, dtype)) for n in (c, 3 * c, 2 * f)]


SHIPPED = [(32 * s, c) for c, s in ((768, 361), (768, 627), (1024, 1369), (1024, 2442),
                                    (1024, 361), (1024, 627))]
RAGGED = [(m, c) for c in (8, 16, 40, 136, 200, 520, 1000, 1920) for m in (100, 1000, 4097)]


@pytest.mark.parametrize("m,c", SHIPPED + RAGGED)
@pytest.mark.parametrize("ctas", [132, 7])
def test_schedule_visits_every_tile_once(m, c, ctas):
    for dtype in (torch.bfloat16, torch.float32):
        for mm_, n, bn in products(m, c, dtype):
            nm, nn = -(-mm_ // BM), -(-n // bn)
            walk = t_motion.wide_schedule(mm_, n, bn, ctas)
            assert len(walk) == min(ctas, nm * nn)
            flat = [t for cta in walk for t in cta]
            assert sorted(flat) == [(i, j) for i in range(nm) for j in range(nn)]
            order = grouped_order(nm, nn)
            for b, cta in enumerate(walk):  # CTA b takes tiles b, b + grid, ... in the grouped order
                assert cta == order[b::len(walk)]


def test_tile_width_rule():
    """bf16 products wider than 128 columns take 128 x 256 tiles, the rest
    (and every fp32 product) 128 x 128; the hidden units pad to whole halves
    of the GEGLU tile."""
    assert [t_motion.wide_bn(n) for n in (8, 120, 128, 136, 3072)] == [128, 128, 128, 256, 256]
    assert {t_motion.wide_bn(n, torch.float32) for n in (8, 136, 8192)} == {128}
    w1 = lambda c, ff: {"w1": torch.zeros(c, 2 * ff * c)}  # noqa: E731
    assert t_motion.wide_hidden(w1(1024, 4)) == 4096
    assert t_motion.wide_hidden(w1(40, 4)) == 256  # 160 -> 192 -> 256: 128 units a GEGLU tile
    assert t_motion.wide_hidden(w1(40, 4), torch.float32) == 192  # 64 units a tile
    assert t_motion.wide_hidden(w1(16, 4)) == 64  # 2F = 128: one 128-column tile


def test_source_plan_is_the_hosts():
    """The source's tile rows, group rows and width rule are the host's, and
    its walk is ``wide_tile``'s."""
    text = SOURCE.read_text()
    assert re.search(r"constexpr int BM = (\d+);", text).group(1) == str(BM)
    assert re.search(r"constexpr int kGroupM = (\d+);", text).group(1) == str(GROUP)
    assert "return sizeof(T) == 2 && n > 128 ? 256 : 128;" in text
    body = text[text.index("void tile_coords("):]
    body = body[:body.index("\n}\n")]
    for line in ("const int per_group = kGroupM * nn;", "const int rows = min(nm - first, kGroupM);",
                 "mb = first + r % rows;", "nb = r / rows;"):
        assert line in body
