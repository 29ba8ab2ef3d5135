"""The port's ``KVStreamingPipeline`` end to end against the JAX one on the
CPU, in fp32 on the same noised weights: a 26-frame 36×44 clip at input
size 28, L = 6 (a warm-up window over frames 0-5, then 20 steady frames),
in plain, chunked, aligned and aligned-chunk mode (chunk 3 leaves two
single steps after six chunks), with host upsampling and an fp16
transfer.  The JAX pipelines of one alignment setting are reused across
chunk sizes (``chunk`` is read per call), which spares their compiles."""

import numpy as np
import pytest

from tests.torch_port_helpers import model_pair, one_torch_thread  # noqa: F401
from video_depth_anything_torch.inference.kv_streaming import KVStreamingPipeline
from video_depth_anything_tpu.inference import kv_streaming as j_kv

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# fp32 parity bound of the JAX package against the torch reference
# (docs/PARITY.md:12); the aligned modes feed every step's depth into a fit.
TOL = dict(rtol=1e-3, atol=2e-4)
KWARGS = dict(input_size=28, inference_length=6)
MODES = {
    "plain": dict(stream_chunk=1),
    "chunked": dict(stream_chunk=3),
    "aligned": dict(stream_chunk=1, align_each_new_frame=True),
    "aligned-chunk": dict(stream_chunk=3, align_each_new_frame=True),
}


@pytest.fixture(scope="module")
def runs(one_torch_thread):
    jm, tm = model_pair("vits", depth=2, seed=3)
    frames = (np.random.RandomState(0).rand(26, 36, 44, 3) * 255).astype(np.uint8)
    pipes = {align: j_kv.KVStreamingPipeline(jm, **KWARGS, align_each_new_frame=align)
             for align in (False, True)}
    want = {}
    for name, mode in MODES.items():
        pipe = pipes[mode.get("align_each_new_frame", False)]
        pipe.chunk = mode["stream_chunk"]
        want[name] = pipe.infer(frames)[0]
    return tm, frames, want


@pytest.mark.parametrize("mode", MODES)
def test_pipeline_matches_jax(runs, mode):
    tm, frames, want = runs
    got, fps = KVStreamingPipeline(tm, **KWARGS, **MODES[mode]).infer(frames, 24.0)
    assert fps == 24.0
    assert got.shape == want[mode].shape == (26, 36, 44) and got.dtype == np.float32
    np.testing.assert_allclose(got, want[mode], **TOL)


def test_host_upsample_and_fp16_transfer(runs):
    """Host upsampling gives the device resize's depth; an fp16 transfer
    rounds each emitted value once (2⁻¹¹ relative)."""
    tm, frames, want = runs
    got, _ = KVStreamingPipeline(tm, **KWARGS, stream_chunk=3, host_upsample=True).infer(frames)
    np.testing.assert_allclose(got, want["chunked"], **TOL)
    got, _ = KVStreamingPipeline(tm, **KWARGS, **MODES["aligned-chunk"],
                                 transfer_dtype="fp16").infer(frames)
    assert got.dtype == np.float32
    ref = want["aligned-chunk"]
    assert np.all(np.abs(got - ref) <= 1e-3 * np.abs(ref) + 2e-4)


def test_refusals(runs):
    tm = runs[0]
    with pytest.raises(ValueError, match="temporal_max_len"):
        KVStreamingPipeline(tm, inference_length=33)
    with pytest.raises(ValueError, match="transfer_dtype"):
        KVStreamingPipeline(tm, transfer_dtype="bf16")
