"""Tensor-parallel streaming over spawned gloo ranks on the CPU: the
feature-cache (``inference/streaming.py``, chunk 2) and KV-cache
(``inference/kv_streaming.py``, chunk 2) pipelines with the encoder split
over two and three ranks (``model_parallel``), inputs replicated, against
the port's single-process pipelines (1e-5, or four times the distance of
the single process with its row-parallel sums split as the ranks split
them, ``torch_parallel_ranks.split_sums``, where these noised weights
amplify that reassociation past 1e-5), every rank holding the same depth,
and against JAX's pipelines (rtol 1e-3)."""

import copy

import numpy as np
import pytest
import torch

from tests import torch_parallel_ranks as ranks
from tests.torch_port_helpers import model_pair, one_torch_thread  # noqa: F401
from video_depth_anything_torch.inference.kv_streaming import KVStreamingPipeline
from video_depth_anything_torch.inference.streaming import StreamingDepthPipeline

pytestmark = pytest.mark.usefixtures("one_torch_thread")

WORLDS = (2, 3)
MODES = ("stream_fc", "stream_kv")


def _pipelines(model):
    return {"stream_fc": StreamingDepthPipeline(model, input_size=28, inference_length=6,
                                                keyframe_list=(2,), chunk_size=2),
            "stream_kv": KVStreamingPipeline(model, input_size=28, inference_length=6,
                                             stream_chunk=2)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("stream")
    jm, tm = model_pair("vits", depth=4, seed=7)
    torch.save(tm.module.state_dict(), tmp / "state.pt")
    frames = (np.random.default_rng(4).random((12, 28, 28, 3)) * 255).astype(np.uint8)
    np.save(tmp / "frames.npy", frames)
    for n in WORLDS:
        out = tmp / f"w{n}"
        out.mkdir()
        ranks.spawn(ranks.tp_streaming, n, tmp, "vits", 4, str(tmp / "state.pt"),
                    str(tmp / "frames.npy"), str(out))
    single = {k: p.infer(frames)[0] for k, p in _pipelines(tm).items()}
    split = {n: {k: p.infer(frames)[0] for k, p in _pipelines(
        _split_model(tm, n)).items()} for n in WORLDS}
    return tmp, frames, single, split, jm


def _split_model(tm, n):
    model = copy.deepcopy(tm)
    ranks.split_sums(model.module, n)
    return model


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", WORLDS)
def test_tp_streaming_matches_single_process(run, n, mode):
    tmp, _, single, split, _ = run
    tol = ranks.floor_tol(split[n][mode], single[mode])
    got = ranks.load(tmp / f"w{n}", mode, 0)
    assert got.shape == single[mode].shape and tol <= 2e-4
    assert _rel(got, single[mode]) <= tol


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", WORLDS)
def test_every_rank_streams_the_same_depth(run, n, mode):
    tmp = run[0] / f"w{n}"
    for r in range(1, n):
        np.testing.assert_array_equal(ranks.load(tmp, mode, r), ranks.load(tmp, mode, 0))


@pytest.mark.parametrize("mode", MODES)
def test_tp_streaming_matches_jax(run, mode):
    from video_depth_anything_tpu.inference import kv_streaming as j_kv
    from video_depth_anything_tpu.inference import streaming as j_stream

    tmp, frames, _, _, jm = run
    if mode == "stream_fc":
        pipe = j_stream.StreamingDepthPipeline(jm, input_size=28, inference_length=6,
                                               keyframe_list=(2,), chunk_size=2)
    else:
        pipe = j_kv.KVStreamingPipeline(jm, input_size=28, inference_length=6, stream_chunk=2)
    want = np.asarray(pipe.infer(frames)[0], np.float32)
    np.testing.assert_allclose(ranks.load(tmp / "w2", mode, 0), want, rtol=1e-3,
                               atol=1e-3 * np.abs(want).max())
