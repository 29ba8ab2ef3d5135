"""Pipeline parallelism over spawned gloo ranks on the CPU
(``parallel/pipeline_parallel.py``): a vits window (depth 6, taps 0, 2, 3
and 5) staged over S = 2 and 3 ranks, with the automatic microbatch count
and with 2, on every rank bit for bit what the stages compute run in one
process (``torch_parallel_ranks.pp_emulated``: the blocks on microbatches),
against the port's single-process forward (1e-5, or four times the
microbatched forward's own distance from it where these noised weights
amplify the GEMMs' batch-size rounding past that) and JAX's (rtol 1e-3);
``refresh_params`` after ``model.module`` is replaced; and the
pipeline-parallel video pipeline against the single-process one."""

import copy

import numpy as np
import pytest
import torch

from tests import torch_parallel_ranks as ranks
from tests.torch_port_helpers import model_pair, one_torch_thread  # noqa: F401
from video_depth_anything_torch.inference.pipeline import VideoDepthPipeline
from video_depth_anything_torch.io.video import read_video_frames, save_video

pytestmark = pytest.mark.usefixtures("one_torch_thread")

STAGES = (2, 3)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp")
    jm, tm = model_pair("vits", depth=6, seed=4)
    _, tm2 = model_pair("vits", depth=6, seed=5)
    torch.save(tm.module.state_dict(), tmp / "state.pt")
    torch.save(tm2.module.state_dict(), tmp / "state2.pt")
    x = np.random.default_rng(1).standard_normal((2, 3, 28, 28, 3)).astype(np.float32)
    np.save(tmp / "x.npy", x)
    clip = (np.random.default_rng(2).random((40, 28, 28, 3)) * 255).astype(np.uint8)
    save_video(clip, str(tmp / "clip.mp4"), fps=24)
    for s in STAGES:
        out = tmp / f"s{s}"
        out.mkdir()
        ranks.spawn(ranks.pp_window, s, tmp, "vits", 6, str(tmp / "state.pt"),
                    str(tmp / "x.npy"), str(out), str(tmp / "clip.mp4"), str(tmp / "state2.pt"))
    frames, _ = read_video_frames(str(tmp / "clip.mp4"))
    bt = x.shape[0] * x.shape[1]
    auto = {s: ranks.pp_emulated(tm, x, {2: 3, 3: 6}[s]) for s in STAGES}
    assert all(bt % m == 0 for m in (2, 3, 6))
    want = {"window": tm.infer_window(x).numpy(), "refreshed": tm2.infer_window(x).numpy(),
            "emulated": {(s, None): auto[s] for s in STAGES}
            | {(s, 2): ranks.pp_emulated(tm, x, 2) for s in STAGES},
            "refreshed_emulated": ranks.pp_emulated(tm2, x, 2),
            "video": VideoDepthPipeline(copy.deepcopy(tm), input_size=28).infer_video_depth(
                frames)[0],
            "jax": np.asarray(jm.infer_window(x), np.float32)}
    return tmp, want


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("m", [None, 2])
@pytest.mark.parametrize("s", STAGES)
def test_pp_window_is_the_microbatched_forward(run, s, m):
    tmp, want = run
    for r in range(s):
        np.testing.assert_array_equal(ranks.load(tmp / f"s{s}", f"pp_{m}", r),
                                      want["emulated"][(s, m)])


@pytest.mark.parametrize("m", [None, 2])
@pytest.mark.parametrize("s", STAGES)
def test_pp_window_matches_single_process(run, s, m):
    tmp, want = run
    tol = ranks.floor_tol(want["emulated"][(s, m)], want["window"])
    assert tol <= 2e-4
    assert _rel(ranks.load(tmp / f"s{s}", f"pp_{m}", 0), want["window"]) <= tol


@pytest.mark.parametrize("s", STAGES)
def test_pp_window_matches_jax(run, s):
    tmp, want = run
    np.testing.assert_allclose(ranks.load(tmp / f"s{s}", "pp_None", 0), want["jax"], rtol=1e-3,
                               atol=1e-3 * np.abs(want["jax"]).max())


@pytest.mark.parametrize("s", STAGES)
def test_pp_refreshes_a_replaced_module(run, s):
    tmp, want = run
    got = ranks.load(tmp / f"s{s}", "pp_refreshed", s - 1)
    np.testing.assert_array_equal(got, want["refreshed_emulated"])
    assert _rel(got, want["window"]) > 1e-2


@pytest.mark.parametrize("s", STAGES)
def test_pp_video_pipeline_matches_single_process(run, s):
    tmp, want = run
    for r in range(s):
        got = ranks.load(tmp / f"s{s}", "pp_video", r)
        assert got.shape == want["video"].shape == (40, 28, 28)
        assert _rel(got, want["video"]) <= 1e-5
