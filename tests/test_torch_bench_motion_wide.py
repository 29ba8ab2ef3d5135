"""``python -m video_depth_anything_torch.bench_motion_tail --wide`` on the
CPU, without a card: its arguments, its refusal to time without a card, the
split builds it makes of the current and of an earlier source, the chain's
products, bound and rows."""

import pytest

from video_depth_anything_torch import bench_motion_tail as bmt
from video_depth_anything_torch.ops import motion_module as mm
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_arguments():
    args = bmt.parse_args(["--wide", "--root", "_scratch/parent", "--domain"])
    assert (args.wide, args.root, args.domain, args.iters) == (True, "_scratch/parent", True, 20)
    assert not bmt.parse_args([]).wide and not bmt.parse_args([]).domain
    with pytest.raises(SystemExit):
        bmt.parse_args(["--domain"])  # the domain configs are the wide chain's


def test_no_card_no_rows(capsys, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert bmt.main(["--wide"]) == 3
    assert capsys.readouterr().out.strip() == "bench_motion_tail: no CUDA device"


def test_current_source_builds_with_flags():
    text = (mm.cuda_build.CSRC / "motion_module_wide.cu").read_text()
    assert bmt.SPLIT_ENTRY in text and bmt.wide_variants(text) == bmt.WIDE_VARIANTS
    for v, i in zip(bmt.WIDE_VARIANTS, (0, 2, 3, 4)):
        src, flags = bmt.wide_source(text, v)
        assert src == text and flags == [f"-DWIDE_SPLIT={i}"]
    for flag in ("WIDE_SPLIT == 2", "WIDE_SPLIT != 3", "WIDE_SPLIT != 4"):
        assert flag in text


def _earlier_source():
    """An earlier source: every anchor of the rewrites, no split entry."""
    anchors = [a for a, _ in bmt._PARENT_MARKS]
    anchors += [a for rw in bmt.PARENT_REWRITES.values() for a, _ in rw]
    return "#include \"motion_module.cuh\"\n" + "\n".join(anchors) + "\n#define VDA_WIDE_ARGS\n"


def test_earlier_source_is_rewritten():
    text = _earlier_source()
    assert bmt.wide_variants(text) == ("full", "noloads", "noepilogue")
    full, flags = bmt.wide_source(text, "full")
    assert flags == [] and full.startswith("#include <cuda_runtime.h>")
    assert "wide_mark(st);\n#define VDA_WIDE_CHECK(call)" in full
    assert full.rstrip().endswith("}") and bmt.SPLIT_ENTRY in full
    noload, _ = bmt.wide_source(text, "noloads")
    assert "tma_load_3d(" not in noload and "mbar_arrive(&full[s]);" in noload
    noepi, _ = bmt.wide_source(text, "noepilogue")
    assert "if (g.M > 0) return;" in noepi
    with pytest.raises(ValueError, match="anchor is missing"):
        bmt.wide_source(text.replace("fence_regs(acc);", ""), "noepilogue")


def test_products_and_bound():
    """The eight products of a two-block module, and the bound chip_smoke.py
    states for Kernel C (44 C² + 8 T C FLOPs a token at 989 TFLOP/s; 3x the
    FLOPs at 495 in 3xTF32)."""
    shapes = bmt.wide_product_shapes(11552, 1024, 4096)
    assert list(shapes) == ["proj_in", "qkv1", "out1", "qkv2", "out2", "geglu", "w2", "proj_out"]
    assert shapes["qkv1"] == (11552, 1024, 3072) and shapes["geglu"] == (11552, 1024, 8192)
    assert shapes["w2"] == (11552, 4096, 1024)
    m, c = 32 * 1369, 1024
    assert bmt.wide_bound_ms(m, c) == pytest.approx(m * (44 * c * c + 8 * 32 * c) / 989e12 * 1e3)
    assert bmt.wide_bound_ms(m, c, f32=True) == pytest.approx(
        3 * m * (44 * c * c + 8 * 32 * c) / 495e12 * 1e3)
    assert bmt.wide_bound_ms(m, c) == pytest.approx(2.0553, abs=1e-4)  # PERF.md's vitl m0 518²


def test_row():
    names = mm.wide_launch_names(2)
    assert len(names) == 14 and names[3] == "qkv1" and names[-1] == "proj_out"
    lib = {k: 0.1 for k in bmt.wide_product_shapes(100, 64, 256)}
    full = [0.01 * (i + 1) for i in range(14)]
    row = bmt.wide_row("vitl m1 518x518", "bf16", 1024, 361, 1.5, {"full": full, "noloads": full},
                       lib, 4096)
    assert row["kernel"] == "motion_module_wide" and row["split_ms"]["gn"] == 0.01
    assert row["split_ms_noloads"]["proj_out"] == pytest.approx(0.14)
    assert row["split_sum_ms"] == pytest.approx(sum(full))
    assert row["library_sum_ms"] == pytest.approx(0.8)
    products = sum(row["split_ms"][k] for k in lib)
    assert row["products/library"] == pytest.approx(products / 0.8)
    assert row["ms/bound_ms"] == pytest.approx(1.5 / row["bound_ms"])
    f32 = bmt.wide_row("x", "fp32", 1024, 361, 1.5, {}, lib, 4096)
    assert f32["kernel"] == "motion_module_wide_f32" and "split_ms" not in f32
