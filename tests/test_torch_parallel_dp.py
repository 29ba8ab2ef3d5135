"""Data-parallel and multi-host window pipelines over spawned gloo ranks on
the CPU (``parallel/data_parallel.py``, the spans of
``parallel/multihost.py``): a
70-frame clip (three windows) at world size 2 and window batch 1, and a
40-frame clip (two windows: the third rank has none, and decodes one frame
for the exchange's shape) at world size 3 and window batch 4, at input
size 28, bit for bit the single-process
``VideoDepthPipeline`` on every rank (each window's forward is the single
process's), over frames in memory and over ranged decodes of the file
(the multi-host CLI's path), each rank having read only its
``host_window_spans`` frames; the exchange in rounds of one window a
group; and the single-process result against JAX's pipeline (rtol
1e-3)."""

import copy

import numpy as np
import pytest
import torch

from tests import torch_parallel_ranks as ranks
from tests.torch_port_helpers import model_pair, one_torch_thread  # noqa: F401
from video_depth_anything_torch.inference.pipeline import VideoDepthPipeline
from video_depth_anything_torch.io.video import read_video_frames, save_video
from video_depth_anything_torch.parallel.multihost import host_window_spans

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CASES = ((2, 1, 70), (3, 4, 40))  # (world size, window batch, frames)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    jm, tm = model_pair("vits", depth=4, seed=6)
    torch.save(tm.module.state_dict(), tmp / "state.pt")
    clip = (np.random.default_rng(3).random((70, 28, 28, 3)) * 255).astype(np.uint8)
    single, frames = {}, {}
    for n, wb, length in CASES:
        video = str(tmp / f"clip{length}.mp4")
        save_video(clip[:length], video, fps=24)
        out = tmp / f"w{n}"
        out.mkdir()
        ranks.spawn(ranks.dp_video, n, tmp, "vits", 4, str(tmp / "state.pt"), video, str(out),
                    wb)
        frames[length], _ = read_video_frames(video)
        single[n] = VideoDepthPipeline(copy.deepcopy(tm), input_size=28,
                                       window_batch=wb).infer_video_depth(frames[length])[0]
    return tmp, frames, single, jm


@pytest.mark.parametrize("n,wb,length", CASES)
def test_data_parallel_pipeline_is_single_process_bit_for_bit(run, n, wb, length):
    tmp, _, single, _ = run
    for r in range(n):
        got = ranks.load(tmp / f"w{n}", "dp", r)
        assert got.shape == (length, 28, 28)
        np.testing.assert_array_equal(got, single[n])


@pytest.mark.parametrize("n,wb,length", CASES)
def test_multihost_pipeline_is_single_process_bit_for_bit(run, n, wb, length):
    tmp, _, single, _ = run
    for r in range(n):
        np.testing.assert_array_equal(ranks.load(tmp / f"w{n}", "mh", r), single[n])


def _spans_read(run, n, length, key):
    spans = host_window_spans(length, n)
    assert (n == 3) == any(s.window_stop == s.window_start for s in spans)
    for r, span in enumerate(spans):
        got = tuple(int(v) for v in ranks.load(run[0] / f"w{n}", key, r))
        want = (span.frame_start, min(span.frame_stop, length)) \
            if span.window_stop > span.window_start else (0, 1)
        assert got == want


@pytest.mark.parametrize("n,wb,length", CASES)
def test_multihost_ranks_decode_their_span_only(run, n, wb, length):
    _spans_read(run, n, length, "mh_decoded")


@pytest.mark.parametrize("n,wb,length", CASES)
def test_data_parallel_ranks_take_their_span_only(run, n, wb, length):
    """Frames in memory go through the same spans as a ranged decode."""
    _spans_read(run, n, length, "dp_decoded")


def test_exchange_holds_one_window_a_group(monkeypatch):
    """The window depths cross in rounds of one window a group: each
    collective carries one window of each, and the rounds give every
    group's windows back in window order."""
    from video_depth_anything_torch.parallel import comm, data_parallel
    from video_depth_anything_torch.parallel.multihost import HostWindowSpan

    spans = [HostWindowSpan(0, 3, 0, 0), HostWindowSpan(3, 4, 0, 0), HostWindowSpan(4, 4, 0, 0)]
    shape = (2, 3, 3)
    windows = [np.full(shape, float(i), np.float32) for i in range(4)]
    local = {0: windows[:3], 1: windows[3:], 2: []}
    calls = []

    def all_gather(t, group):
        calls.append(tuple(t.shape))
        r = len(calls) - 1
        return [torch.from_numpy(local[h][r] if r < len(local[h]) else np.zeros(shape,
                                                                              np.float32))
                for h in range(3)]

    monkeypatch.setattr(comm, "all_gather", all_gather)
    got = data_parallel.exchange_windows(local[0], spans, shape, comm.Group((0, 1, 2)))
    assert calls == [shape] * 3
    assert [float(w[0, 0, 0]) for w in got] == [0.0, 1.0, 2.0, 3.0]


def test_single_process_pipeline_matches_jax(run):
    from video_depth_anything_tpu.inference.pipeline import VideoDepthPipeline as JaxPipeline

    _, frames, single, jm = run
    want, _ = JaxPipeline(jm, input_size=28, window_batch=1).infer_video_depth(frames[70])
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(single[2], want, rtol=1e-3, atol=1e-3 * np.abs(want).max())
