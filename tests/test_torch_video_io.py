"""The port's video I/O (``video_depth_anything_torch/io/video.py``) against
the JAX package's (``video_depth_anything_tpu/io/video.py``): the depth
colormaps bit for bit on uint8, the port's committed tables against
matplotlib's, the cv2 decode path with its sampling and downscale, and the
depth video written with either colormap."""

import cv2
import matplotlib
import numpy as np
import pytest

from video_depth_anything_torch.io import colormaps
from video_depth_anything_torch.io import video as t_video
from video_depth_anything_tpu.io import video as j_video
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MODES = {"inferno": {}, "spectral": {"spectral": True}, "grayscale": {"grayscale": True}}


def _depths(kind: str) -> np.ndarray:
    """A seeded fp32 depth stack (4 × 16 × 24), or a constant one, whose
    min-max denominator is 0."""
    if kind == "constant":
        return np.full((4, 16, 24), 3.25, np.float32)
    rng = np.random.RandomState(11)
    return (rng.rand(4, 16, 24) * 40.0 + 0.5).astype(np.float32)


@pytest.mark.parametrize("stack", ["seeded", "constant"])
@pytest.mark.parametrize("mode", list(MODES))
def test_colorize_depth_matches_jax(mode, stack):
    d = _depths(stack)
    got = t_video.colorize_depth(d, **MODES[mode])
    want = j_video.colorize_depth(d, **MODES[mode])
    assert got.dtype == np.uint8 and got.shape == d.shape + (3,)
    np.testing.assert_array_equal(got, want)


def test_colorize_depth_covers_every_table_entry():
    """A ramp through all 256 levels reaches every entry of both tables."""
    d = np.linspace(0.0, 1.0, 4 * 16 * 16, dtype=np.float32).reshape(4, 16, 16)
    for kw in ({}, {"spectral": True}):
        np.testing.assert_array_equal(t_video.colorize_depth(d, **kw),
                                      j_video.colorize_depth(d, **kw))


@pytest.mark.parametrize("name,table", [("inferno", colormaps.INFERNO),
                                        ("Spectral", colormaps.SPECTRAL)])
def test_committed_tables_are_matplotlibs(name, table):
    cmap = matplotlib.colormaps[name]
    want = (np.asarray(cmap(np.arange(256) / 255.0))[:, :3] * 255).astype(np.uint8)
    assert table.shape == (256, 3) and table.dtype == np.uint8
    np.testing.assert_array_equal(table, want)


def _write_clip(path, frames: int = 24, h: int = 72, w: int = 120, fps: float = 24.0) -> str:
    """A seeded synthetic mp4 (mp4v): moving gradients and noise."""
    rng = np.random.RandomState(3)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    assert writer.isOpened()
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(frames):
        img = np.stack([(xx * 2 + i * 5) % 256, (yy * 3 + i * 7) % 256,
                        rng.randint(0, 256, (h, w))], axis=-1).astype(np.uint8)
        writer.write(img)
    writer.release()
    return str(path)


@pytest.mark.parametrize("process_length,target_fps,max_res", [
    (-1, -1, -1),   # every frame, full size
    (5, 8, 64),     # every third frame, at most 5 of them, longer side 64 (even sizes)
    (-1, 12, 100),  # every second frame, downscaled
])
def test_read_video_frames_matches_jax(tmp_path, monkeypatch, process_length, target_fps, max_res):
    monkeypatch.setenv("VDA_NATIVE_DECODE", "0")  # the JAX package's cv2 loop
    clip = _write_clip(tmp_path / "clip.mp4")
    got, got_fps = t_video.read_video_frames(clip, process_length, target_fps, max_res)
    want, want_fps = j_video.read_video_frames(clip, process_length, target_fps, max_res)
    assert got_fps == want_fps
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if max_res > 0:
        assert max(got.shape[1:3]) <= max_res + 1 and got.shape[1] % 2 == 0 == got.shape[2] % 2


@pytest.mark.parametrize("spectral", [False, True])
def test_save_video_writes_jax_depth_video(tmp_path, monkeypatch, spectral):
    """``save_video(..., is_depths=True, spectral=...)`` writes the clip the
    JAX package writes: the same frames decode from both files."""
    monkeypatch.setenv("VDA_NATIVE_DECODE", "0")
    d = _depths("seeded")
    paths = [str(tmp_path / f"{who}.mp4") for who in ("port", "jax")]
    t_video.save_video(d, paths[0], fps=10, is_depths=True, spectral=spectral)
    j_video.save_video(d, paths[1], fps=10, is_depths=True, spectral=spectral)
    got, want = (t_video.read_video_frames(p)[0] for p in paths)
    assert got.shape == (4, 16, 24, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["seeded", "constant"])
def test_tiff_stack_round_trip_bit_for_bit_and_read_by_jax(tmp_path, kind):
    """``write_tiff_stack`` → ``read_tiff_stack`` gives the stack back bit
    for bit (NaN, ±inf, subnormals and -0.0 too), and each package reads
    the other's file to the same bits."""
    depths = _depths(kind)
    depths[0, 0, :5] = [np.nan, np.inf, -np.inf, np.float32(1e-45), -0.0]
    paths = {}
    for name, mod in (("port", t_video), ("jax", j_video)):
        paths[name] = str(tmp_path / f"{name}.tiff")
        mod.write_tiff_stack(paths[name], depths)
    for path in paths.values():
        for mod in (t_video, j_video):
            back = mod.read_tiff_stack(path)
            assert back.dtype == np.float32 and back.shape == depths.shape
            np.testing.assert_array_equal(back.view(np.uint32), depths.view(np.uint32))


def test_tiff_stack_refuses_an_empty_stack(tmp_path):
    for mod in (t_video, j_video):
        with pytest.raises(ValueError, match="empty depth stack"):
            mod.write_tiff_stack(str(tmp_path / "empty.tiff"), np.zeros((0, 4, 4), np.float32))
