"""The port's ``KVStreamingPipeline`` against the JAX one with
``skip_tmp_block`` (motion module 2 never runs and has no cache), on the
26-frame clip of tests/test_torch_kv_streaming.py in chunked mode and on
a 4-frame clip, shorter than the warm-up window of L = 6, which is padded
with its last frame.  Its own file: the skip variants are JAX compiles of
their own."""

import numpy as np

from tests.torch_port_helpers import model_pair, one_torch_thread  # noqa: F401
from video_depth_anything_torch.inference.kv_streaming import KVStreamingPipeline
from video_depth_anything_tpu.inference import kv_streaming as j_kv
import pytest

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = dict(rtol=1e-3, atol=2e-4)  # docs/PARITY.md:12
KWARGS = dict(input_size=28, inference_length=6, stream_chunk=3)


def test_skip_tmp_block_and_short_clip_match_jax(one_torch_thread):
    jm, tm = model_pair("vits", depth=2, seed=3)
    frames = (np.random.RandomState(0).rand(26, 36, 44, 3) * 255).astype(np.uint8)
    jpipe, tpipe = j_kv.KVStreamingPipeline(jm, **KWARGS), KVStreamingPipeline(tm, **KWARGS)
    for clip in (frames, frames[:4]):
        want = jpipe.infer(clip, skip_tmp_block=True)[0]
        got = tpipe.infer(clip, skip_tmp_block=True)[0]
        assert got.shape == want.shape == (len(clip), 36, 44)
        np.testing.assert_allclose(got, want, **TOL)
