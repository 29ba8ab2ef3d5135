"""The window pipeline's and the streaming pipelines' options against the
JAX package on the CPU: ``bucket_model_size`` and ``--shape_bucket``, the
transfer dtype (``VDA_TRANSFER_DTYPE`` and ``transfer_dtype``), the
pipelined preprocessing and lagged copies against the synchronous path (bit
for bit), a producer error raised again, the ``VDA_*`` switches read as the
JAX package reads them, and the CLI's ``--save_*`` outputs against the JAX
``run.py``'s on the same clip and weights."""

import json
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import model_pair, one_torch_thread  # noqa: F401
from video_depth_anything_torch.config import INFER_LEN, OVERLAP
from video_depth_anything_torch.inference import kv_streaming as t_kv
from video_depth_anything_torch.inference import pipeline as t_pipe
from video_depth_anything_torch.inference import streaming as t_stream
from video_depth_anything_torch.utils import device as t_device
from video_depth_anything_torch.utils import transform as t_transform
from video_depth_anything_tpu.inference import kv_streaming as j_kv
from video_depth_anything_tpu.inference import pipeline as j_pipe
from video_depth_anything_tpu.inference import streaming as j_stream
from video_depth_anything_tpu.utils import transform as j_transform

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = dict(rtol=1e-3, atol=2e-4)  # the fp32 parity bound (docs/PARITY.md:12)


def _clip(n=76, h=48, w=64):
    yy, xx = np.mgrid[0:h, 0:w]
    frames = np.zeros((n, h, w, 3), np.uint8)
    for i in range(n):
        frames[i, ..., 0] = (xx * 4 + i * 3) % 256
        frames[i, ..., 1] = (yy * 5) % 256
        frames[i, ..., 2] = ((xx - w // 2) ** 2 + (yy - i % h) ** 2 < 80) * 255
    return frames


@pytest.fixture(scope="module")
def pair():
    return model_pair("vits", depth=2, seed=3)


def test_bucket_model_size_matches_jax():
    for h in (48, 240, 360, 480, 518, 720, 1080):
        for w in (64, 320, 640, 854, 924, 1280, 1920):
            for size in (28, 518):
                for bucket in (14, 28, 56, 70, 112):
                    assert t_transform.bucket_model_size(h, w, size, bucket) == \
                        j_transform.bucket_model_size(h, w, size, bucket), (h, w, size, bucket)
    for mod in (t_transform, j_transform):
        with pytest.raises(ValueError, match="multiple of the 14-pixel patch"):
            mod.bucket_model_size(480, 640, 518, 50)


def test_shape_bucket_matches_jax_pipeline(pair):
    jm, tm = pair
    frames = _clip()
    want, _ = j_pipe.VideoDepthPipeline(jm, input_size=28, shape_bucket=56).infer_video_depth(
        frames)
    pipe = t_pipe.VideoDepthPipeline(tm, input_size=28, shape_bucket=56)
    assert pipe._target_hw(48, 64) == (56, 56)
    got, _ = pipe.infer_video_depth(frames)
    assert got.shape == want.shape == frames.shape[:3]
    np.testing.assert_allclose(got, want, **TOL)


def test_fp16_transfer_matches_jax_fp16(pair, monkeypatch):
    """JAX's fp16 copies (``VDA_TRANSFER_DTYPE=fp16``, read at trace time)
    against the port's, from the environment and from the argument; fp32
    on the host either way."""
    jm, tm = pair
    frames = _clip()
    monkeypatch.setenv("VDA_TRANSFER_DTYPE", "fp16")
    want, _ = j_pipe.VideoDepthPipeline(jm, input_size=28).infer_video_depth(frames)
    from_env = t_pipe.VideoDepthPipeline(tm, input_size=28)
    assert from_env.transfer_dtype == torch.float16
    got, _ = from_env.infer_video_depth(frames)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    monkeypatch.setenv("VDA_TRANSFER_DTYPE", "fp32")
    explicit = t_pipe.VideoDepthPipeline(tm, input_size=28, transfer_dtype="fp16")
    assert explicit.transfer_dtype == torch.float16
    np.testing.assert_array_equal(explicit.infer_video_depth(frames)[0], got)


@pytest.mark.parametrize("env,arg,want", [
    (None, None, torch.float32), ("fp16", None, torch.float16), ("float16", None, torch.float16),
    ("bf16", None, torch.float32), ("fp16", "fp32", torch.float32), (None, "fp16", torch.float16),
])
def test_transfer_dtype_read_as_jax_reads_it(monkeypatch, env, arg, want):
    if env is None:
        monkeypatch.delenv("VDA_TRANSFER_DTYPE", raising=False)
    else:
        monkeypatch.setenv("VDA_TRANSFER_DTYPE", env)
    assert t_device.resolve_transfer_dtype(arg) == want
    if arg is None:  # JAX reads the environment alone
        from video_depth_anything_tpu.utils.device import transfer_cast

        jax_dtype = transfer_cast(jnp.zeros(2, jnp.float32)).dtype
        assert str(jax_dtype) == str(want).removeprefix("torch.")
    with pytest.raises(ValueError, match="fp32|fp16"):
        t_device.resolve_transfer_dtype("bf16")


def test_pipelined_preprocessing_and_lagged_copies_equal_the_serial_path(pair, monkeypatch):
    """Four window batches (window_batch 1): the producer thread and the
    one-batch lag give the serial path's depths bit for bit; the lag is
    off from ``D2H_OVERLAP_BYTES`` a batch; progress counts the batches."""
    _, tm = pair
    frames = _clip()
    pipe = t_pipe.VideoDepthPipeline(tm, input_size=28, window_batch=1)
    got, _ = pipe.infer_video_depth(frames, progress=True)
    n, fh, fw = frames.shape[:3]
    pre = np.empty((t_pipe.padded_length(n),) + t_transform.model_size_for(fh, fw, 28) + (3,),
                   np.float32)
    pre[:n] = t_transform.preprocess_frames(frames, 28)
    pre[n:] = pre[n - 1]
    drained = []
    real = t_pipe.HostTransfer.numpy
    monkeypatch.setattr(t_pipe.HostTransfer, "numpy",
                        lambda self: drained.append(1) or real(self))
    monkeypatch.setattr(t_pipe, "D2H_OVERLAP_BYTES", 0)
    serial = t_pipe.stitch_windows(
        pipe.compute_window_depths(pre, t_pipe.window_frame_indices(n), fh, fw), n)
    assert len(drained) == t_pipe.num_windows(n) == 4
    np.testing.assert_array_equal(got, serial)


def test_producer_error_is_raised_in_the_caller(pair, monkeypatch):
    _, tm = pair
    calls = []

    def failing(frames, input_size, target_hw):
        calls.append(len(frames))
        if len(calls) == 2:
            raise RuntimeError("decode failed in chunk 2")
        return np.zeros((len(frames),) + target_hw + (3,), np.float32)

    monkeypatch.setattr(t_pipe, "preprocess_frames", failing)
    pipe = t_pipe.VideoDepthPipeline(tm, input_size=28)
    with pytest.raises(RuntimeError, match="decode failed in chunk 2"):
        pipe.infer_video_depth(_clip())
    assert calls == [INFER_LEN - OVERLAP] * 2  # frames a chunk


class _Model:
    """What the pipelines' constructors read of a model."""

    class cfg:  # noqa: N801
        features = 64

        class motion:  # noqa: N801
            temporal_max_len = 32


@pytest.mark.parametrize("value", [None, "0", "1", "", "yes"])
def test_switches_read_as_jax_reads_them(pair, monkeypatch, value):
    """``VDA_HOST_UPSAMPLE`` (window, feature-cache and KV pipelines),
    ``VDA_DEVICE_ALIGN`` and ``VDA_RING_DTYPE`` at each value, against the
    JAX pipelines' constructors (``VDA_DEVICE_ALIGN``: the JAX ``infer``'s
    test); an explicit argument wins."""
    jm, tm = pair
    for name in ("VDA_HOST_UPSAMPLE", "VDA_DEVICE_ALIGN"):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    kw = dict(inference_length=8, keyframe_list=(4,))
    want = j_pipe.VideoDepthPipeline(jm).host_upsample
    assert t_pipe.VideoDepthPipeline(tm).host_upsample == want
    assert t_stream.StreamingDepthPipeline(_Model(), **kw).host_upsample == \
        j_stream.StreamingDepthPipeline(jm, **kw).host_upsample == want
    assert t_kv.KVStreamingPipeline(_Model(), inference_length=8).host_upsample == \
        j_kv.KVStreamingPipeline(jm, inference_length=8).host_upsample == want
    assert t_pipe.VideoDepthPipeline(tm, host_upsample=not want).host_upsample == (not want)
    align = t_stream.StreamingDepthPipeline(_Model(), align_each_new_frame=True, **kw)
    assert align.device_align == (os.environ.get("VDA_DEVICE_ALIGN", "1") != "0")
    assert t_stream.StreamingDepthPipeline(_Model(), device_align=False, **kw).device_align \
        is False


@pytest.mark.parametrize("env,arg", [(None, None), ("fp16", None), ("bf16", None),
                                     ("fp16", "fp32"), ("fp8", None)])
def test_ring_dtype_read_as_jax_reads_it(pair, monkeypatch, env, arg):
    jm, _ = pair
    if env is None:
        monkeypatch.delenv("VDA_RING_DTYPE", raising=False)
    else:
        monkeypatch.setenv("VDA_RING_DTYPE", env)
    kw = dict(inference_length=8, keyframe_list=(4,), ring_dtype=arg)
    if env == "fp8":
        for cls, m in ((t_stream.StreamingDepthPipeline, _Model()),
                       (j_stream.StreamingDepthPipeline, jm)):
            with pytest.raises(ValueError, match="ring_dtype"):
                cls(m, **kw)
        return
    got = t_stream.StreamingDepthPipeline(_Model(), **kw).ring_dtype
    want = j_stream.StreamingDepthPipeline(jm, **kw).ring_dtype
    assert str(got).removeprefix("torch.") == jnp.dtype(want).name


def _write_clip(path, frames):
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10,
                             (frames.shape[2], frames.shape[1]))
    for f in frames:
        writer.write(f)
    writer.release()


def test_cli_outputs_match_jax_run(tmp_path, monkeypatch):
    """``--save_tiff --save_orig --save_vis --save_stats`` (and
    ``--save_npz``) on the CPU against the JAX ``run.py`` on the same clip
    and the same full vits weights (one ``.pth``): the same file names,
    depth within the fp32 bound, the stats record's keys; ``--save_exr``
    with ``cv2.imwrite`` recorded (this cv2 has no EXR writer)."""
    import run as j_run
    from video_depth_anything_torch import run as t_run
    from video_depth_anything_torch.io.video import read_tiff_stack
    from video_depth_anything_torch.models.vda import VDAModel

    monkeypatch.setenv("VDA_COMPILE_CACHE", "0")
    model = VDAModel("vits", device="cpu", dtype=torch.float32)
    model.init_params(seed=0)
    ckpt = str(tmp_path / "vits.pth")
    torch.save(model.module.state_dict(), ckpt)
    clip = str(tmp_path / "clip.mp4")
    _write_clip(clip, _clip(n=14))
    flags = ["--input_video", clip, "--checkpoint", ckpt, "--fp32", "--input_size", "28",
             "--save_tiff", "--save_orig", "--save_vis", "--save_stats", "--save_npz"]
    out = {}
    for name, main, extra in (("jax", j_run.main, []),
                              ("port", t_run.main, ["--device", "cpu"])):
        d = tmp_path / name
        assert main(flags + ["--output_dir", str(d)] + extra) == 0
        out[name] = d
    names = sorted(os.listdir(out["jax"]))
    assert names == sorted(os.listdir(out["port"])) == [
        "clip_depth.mp4", "clip_depth.npz", "clip_depths.tiff", "clip_orig.mp4", "clip_vis.mp4",
        "inference_log.txt"]
    want = read_tiff_stack(str(out["jax"] / "clip_depths.tiff"))
    got = read_tiff_stack(str(out["port"] / "clip_depths.tiff"))
    assert got.shape == want.shape == (14, 48, 64)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(np.load(out["port"] / "clip_depth.npz")["depth"], got)
    recs = {k: json.loads((v / "inference_log.txt").read_text().splitlines()[-1])
            for k, v in out.items()}
    assert recs["port"].keys() == recs["jax"].keys()
    assert recs["port"]["frames_predicted"] == 14 and recs["port"]["device_memory"] == {}
    assert recs["port"]["args"]["save_tiff"] is True
    written = []
    monkeypatch.setattr(cv2, "imwrite", lambda path, img: written.append((path, img)) or True)
    d = tmp_path / "exr"
    assert t_run.main(flags[:4] + ["--fp32", "--input_size", "28", "--save_exr", "--device", "cpu",
                                   "--output_dir", str(d)]) == 0
    assert [os.path.relpath(p, d) for p, _ in written] == [f"clip_exr/{i:05d}.exr"
                                                           for i in range(14)]
    np.testing.assert_array_equal(np.stack([img for _, img in written]), got)
