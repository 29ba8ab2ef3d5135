"""The port's sliding-window pipeline against the JAX pipeline: window
indices and stitching equal, and end-to-end depth of a 76-frame synthetic
clip (3 windows) within the fp32 parity bound; plus the CLI on the CPU."""

import os

import cv2
import numpy as np
import pytest

from tests.torch_port_helpers import model_pair
from video_depth_anything_torch.inference import pipeline as t_pipe
from video_depth_anything_tpu.inference import pipeline as j_pipe
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = dict(rtol=1e-3, atol=2e-4)  # docs/PARITY.md:12


@pytest.mark.parametrize("n", [1, 31, 32, 33, 76, 100])
def test_window_algebra_equals_jax(n):
    assert t_pipe.num_windows(n) == j_pipe.num_windows(n)
    assert t_pipe.padded_length(n) == j_pipe.padded_length(n)
    np.testing.assert_array_equal(t_pipe.window_frame_indices(n), j_pipe.window_frame_indices(n))


def test_stitch_equals_jax():
    rng = np.random.RandomState(0)
    windows = [rng.rand(32, 6, 8).astype(np.float32) * (w + 1) for w in range(4)]
    np.testing.assert_array_equal(t_pipe.stitch_windows(windows, 80),
                                  j_pipe.stitch_windows(windows, 80))


def _clip(n=76, h=48, w=64):
    yy, xx = np.mgrid[0:h, 0:w]
    frames = np.zeros((n, h, w, 3), np.uint8)
    for i in range(n):
        frames[i, ..., 0] = (xx * 4 + i * 3) % 256
        frames[i, ..., 1] = (yy * 5) % 256
        frames[i, ..., 2] = ((xx - w // 2) ** 2 + (yy - i % h) ** 2 < 80) * 255
    return frames


@pytest.mark.parametrize("host_upsample", [False, True])
def test_video_depth_matches_jax_pipeline(monkeypatch, host_upsample):
    monkeypatch.setenv("VDA_NATIVE_PREPROC", "0")
    jm, tm = model_pair("vits", depth=2, seed=3)
    frames = _clip()
    want, _ = j_pipe.VideoDepthPipeline(jm, input_size=28).infer_video_depth(frames)
    pipe = t_pipe.VideoDepthPipeline(tm, input_size=28, host_upsample=host_upsample)
    assert pipe.window_batch == 4
    got, _ = pipe.infer_video_depth(frames)
    assert got.shape == want.shape == frames.shape[:3]
    np.testing.assert_allclose(got, want, **TOL)


def test_cli_on_cpu(tmp_path):
    from video_depth_anything_torch import run

    path = str(tmp_path / "clip.mp4")
    frames = _clip(n=40)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    for f in frames:
        writer.write(f)
    writer.release()
    rc = run.main(["--input_video", path, "--output_dir", str(tmp_path), "--random_init",
                   "--device", "cpu", "--fp32", "--input_size", "28", "--save_npz"])
    assert rc == 0
    depth = np.load(tmp_path / "clip_depth.npz")["depth"]
    assert depth.shape == (40, 48, 64) and np.isfinite(depth).all()
    assert os.path.getsize(tmp_path / "clip_depth.mp4") > 0
