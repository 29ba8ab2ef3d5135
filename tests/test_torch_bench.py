"""The port's benchmark (``python -m video_depth_anything_torch.bench``) on
the CPU: each row function at a small size returns the JAX ``bench.py``
row's fields (without ``mem_static``), and ``main`` keeps the JAX output
contract with the row functions replaced by stubs."""

import json

import pytest
import torch

from video_depth_anything_torch import bench

# The JAX rows' fields (bench.py:144-153, :222-229, :322-330, :385-394),
# mem_static left out: eager PyTorch has no compiler byte accounting.
WINDOW_KEYS = ["encoder", "size", "frames", "batch", "compile_s", "median_window_s",
               "frames_per_s", "ms_per_frame", "mem"]
STREAM_KEYS = ["encoder", "size", "chunk", "compile_s", "median_step_s", "frames_per_s", "mem"]
KV_KEYS = ["encoder", "size", "chunk", "aligned", "compile_s", "median_step_s", "frames_per_s",
           "mem"]
TRAIN_KEYS = ["encoder", "size", "frames", "clips_per_step", "compile_s", "step_s",
              "clip_frames_per_s_per_chip", "loss", "mem"]
# JAX bench.py:458-478
ROW_KEYS = ["vitl", "kv_streaming_vits_chunked", "kv_streaming_vits_aligned_chunked", "vits_wb4",
            "vitb", "streaming_vits_chunked", "kv_streaming_vits", "kv_streaming_vits_aligned",
            "vitl_fast", "vitb_wb4", "streaming_vits", "kv_streaming_vitb", "kv_streaming_vitl",
            "kv_streaming_vitl_chunked", "dp_vits", "train_vits"]


@pytest.fixture(scope="module")
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _timings_ok(row, *keys):
    return all(isinstance(row[k], float) and row[k] > 0 for k in keys)


def test_bench_window_row(few_threads):
    row = bench.bench_window("vits", size=70, frames=8, iters=1, warmup=0, device="cpu")
    assert list(row) == WINDOW_KEYS
    assert (row["encoder"], row["size"], row["frames"], row["batch"]) == ("vits", 70, 8, 1)
    assert _timings_ok(row, "median_window_s", "frames_per_s", "ms_per_frame")
    assert row["mem"] == {}  # no device memory on the CPU


def test_bench_streaming_row(few_threads):
    row = bench.bench_streaming("vits", size=70, iters=1, warmup=0, chunk=8, device="cpu")
    assert list(row) == STREAM_KEYS
    assert row["chunk"] == 8 and _timings_ok(row, "median_step_s", "frames_per_s")


@pytest.mark.parametrize("chunk,aligned", [(1, False), (2, True)])
def test_bench_kv_streaming_row(few_threads, chunk, aligned):
    row = bench.bench_kv_streaming("vits", size=70, iters=1, warmup=0, chunk=chunk,
                                   aligned=aligned, device="cpu")
    assert list(row) == KV_KEYS
    assert (row["chunk"], row["aligned"]) == (chunk, aligned)
    assert _timings_ok(row, "median_step_s", "frames_per_s")


# JAX bench.py:437-444, with the port's detail (how many ranks ran)
DP_KEYS = ["encoder", "devices", "compile_s", "frames_per_s_total", "frames_per_s_per_chip",
           "mem", "detail"]


def test_bench_data_parallel_row(few_threads):
    row = bench.bench_data_parallel("vits", size=70, frames=4, iters=1, warmup=0, device="cpu")
    assert list(row) == DP_KEYS
    assert (row["encoder"], row["devices"]) == ("vits", 1)
    assert _timings_ok(row, "frames_per_s_total", "frames_per_s_per_chip")
    assert row["frames_per_s_total"] == row["frames_per_s_per_chip"]
    assert row["detail"].startswith("world size 1, backend none: one rank")


def test_bench_train_row(few_threads):
    row = bench.bench_train("vits", size=28, frames=8, iters=1, device="cpu")
    assert list(row) == TRAIN_KEYS
    assert row["clips_per_step"] == 1 and _timings_ok(row, "step_s", "clip_frames_per_s_per_chip")
    assert row["loss"] == row["loss"]  # finite, not nan


def test_extra_rows_are_the_jax_ones():
    assert [k for k, _ in bench.EXTRA_ROWS] == ROW_KEYS


@pytest.fixture
def stubbed(monkeypatch):
    """``main`` on a pretended card: rows replaced by stubs, prints
    recorded with their ``flush`` argument."""
    printed = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench, "card_line", lambda: "Stub H100, 700.00 W")
    monkeypatch.setattr(bench, "print", lambda *a, **k: printed.append((a, k)), raising=False)
    monkeypatch.setattr(bench, "bench_window", lambda *a, **k: {"frames_per_s": 100.0})
    monkeypatch.setattr(bench, "bench_streaming", lambda *a, **k: {"frames_per_s": 1.0})
    monkeypatch.setattr(bench, "bench_kv_streaming", lambda *a, **k: {"frames_per_s": 2.0})
    monkeypatch.setattr(bench, "bench_train", lambda *a, **k: {"step_s": 3.0})
    monkeypatch.setattr(bench, "bench_data_parallel", lambda *a, **k: {"devices": 1})
    monkeypatch.delenv("VDA_BENCH_FAST", raising=False)
    monkeypatch.delenv("VDA_BENCH_BUDGET_S", raising=False)
    return printed


def _stdout(printed):
    return [(a[0], k.get("flush")) for a, k in printed if "file" not in k]


def test_main_prints_card_headline_then_full_line(stubbed):
    assert bench.main() == 0
    out = _stdout(stubbed)
    assert out[0][0] == "Stub H100, 700.00 W"
    head, full = json.loads(out[1][0]), json.loads(out[-1][0])
    assert out[1][1] is True and len(out) == 3  # the headline flushed at once
    fields = ("metric", "value", "unit", "vs_baseline")
    assert {k: head[k] for k in fields} == {k: full[k] for k in fields}
    assert head["metric"] == "frames/sec/chip vits 1x32x518x518 bf16"
    assert head["vs_baseline"] == round(100.0 / (1000.0 / 7.5), 3)
    assert list(full["detail"]) == ["window_vits"] + ROW_KEYS + ["elapsed_s"]
    assert full["detail"]["dp_vits"] == {"devices": 1}
    assert full["detail"]["train_vits"] == {"step_s": 3.0}


def test_main_budget_skips_rows(stubbed, monkeypatch):
    monkeypatch.setenv("VDA_BENCH_BUDGET_S", "0")
    assert bench.main() == 0
    detail = json.loads(_stdout(stubbed)[-1][0])["detail"]
    assert all(detail[k] == "SKIPPED: time budget" for k in ROW_KEYS)


def test_main_fast_prints_the_headline_only(stubbed, monkeypatch):
    monkeypatch.setenv("VDA_BENCH_FAST", "1")
    assert bench.main() == 0
    out = _stdout(stubbed)
    assert len(out) == 2 and list(json.loads(out[1][0])["detail"]) == ["window_vits"]


def test_main_records_a_failing_row_and_returns_1(stubbed, monkeypatch):
    def boom(*a, **k):
        raise ValueError("no good")

    monkeypatch.setattr(bench, "bench_train", boom)
    assert bench.main() == 1
    detail = json.loads(_stdout(stubbed)[-1][0])["detail"]
    assert detail["train_vits"] == "ERROR: ValueError: no good"
    assert detail["vitl"] == {"frames_per_s": 100.0}


def test_main_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main()
