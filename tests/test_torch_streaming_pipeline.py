"""The port's ``StreamingDepthPipeline`` end to end against the JAX one on
the CPU, in fp32 on the same noised weights: a 26-frame 36×44 clip at
input size 28, L = 6, keyframes (2,) (as tests/test_streaming_parity.py):
5 warm-up frames, 3 transition steps, then 18 steady frames, in each
steady-state mode.  The JAX pipelines of one alignment setting are reused
across chunk sizes (``chunk`` is read per call), which spares their
compiles; the fit-chain modes with the host fit read the JAX
``VDA_DEVICE_ALIGN`` switch."""

import numpy as np
import pytest

from tests.torch_port_helpers import model_pair, one_torch_thread  # noqa: F401
from video_depth_anything_torch.inference import streaming as t_stream
from video_depth_anything_tpu.inference import streaming as j_stream

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# fp32 parity bound of the JAX package against the torch reference
# (docs/PARITY.md:12).  The aligned modes feed each emitted depth into later
# fits; on this clip the compounded drift stays inside the same bound.
TOL = dict(rtol=1e-3, atol=2e-4)
KWARGS = dict(input_size=28, inference_length=6, keyframe_list=(2,))
MODES = {
    "plain": dict(chunk_size=1),
    "chunked": dict(chunk_size=5),
    "aligned": dict(chunk_size=1, align_each_new_frame=True),
    "aligned-host-fit": dict(chunk_size=1, align_each_new_frame=True, device_align=False),
    "aligned-chunk": dict(chunk_size=4, align_each_new_frame=True),
}


@pytest.fixture(scope="module")
def runs(one_torch_thread):
    jm, tm = model_pair("vits", depth=2, seed=3)
    frames = (np.random.RandomState(0).rand(26, 36, 44, 3) * 255).astype(np.uint8)
    mp = pytest.MonkeyPatch()
    want, pipes = {}, {}
    for name, mode in MODES.items():
        mode = dict(mode)
        device_align = mode.pop("device_align", True)
        align = mode.get("align_each_new_frame", False)
        pipe = pipes.setdefault(align, j_stream.StreamingDepthPipeline(jm, **KWARGS, **mode))
        pipe.chunk = min(mode["chunk_size"], pipe.cache_len - 2)
        mp.setenv("VDA_DEVICE_ALIGN", "1" if device_align else "0")
        want[name] = pipe.infer(frames)[0]
    mp.undo()
    return tm, frames, want


@pytest.mark.parametrize("mode", MODES)
def test_pipeline_matches_jax(runs, mode):
    tm, frames, want = runs
    got, fps = t_stream.StreamingDepthPipeline(tm, **KWARGS, **MODES[mode]).infer(frames, 24.0)
    n = len(frames) - (1 if "align" in mode else KWARGS["inference_length"] - 1)
    assert fps == 24.0
    assert got.shape == want[mode].shape == (n, 36, 44) and got.dtype == np.float32
    np.testing.assert_allclose(got, want[mode], **TOL)


def test_ring_and_transfer_dtypes(runs):
    """fp16 transfer and a bf16 ring: the emitted depths stay within one
    fp16 rounding (transfer) and the fits' quantized references (ring) of
    the fp32 run."""
    tm, frames, want = runs
    got, _ = t_stream.StreamingDepthPipeline(tm, **KWARGS, **MODES["aligned-chunk"],
                                             ring_dtype="bf16", transfer_dtype="fp16").infer(frames)
    scale = np.abs(want["aligned-chunk"]).max()
    assert got.dtype == np.float32
    assert np.abs(got - want["aligned-chunk"]).max() / scale < 2e-2


def test_host_upsample_matches(runs):
    tm, frames, want = runs
    got, _ = t_stream.StreamingDepthPipeline(tm, **KWARGS, **MODES["chunked"],
                                             host_upsample=True).infer(frames)
    np.testing.assert_allclose(got, want["chunked"], **TOL)


def test_short_clip_gives_no_depth(runs):
    tm, frames, _ = runs
    got, _ = t_stream.StreamingDepthPipeline(tm, **KWARGS).infer(frames[:4])
    assert got.shape == (0, 36, 44)
