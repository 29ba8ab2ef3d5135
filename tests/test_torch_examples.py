"""The port's examples (``video_depth_anything_torch/examples``) and stress
tool (``tools/stress.py``) at tiny sizes on the CPU: quickstart writes a
depth video of the clip's frames, ``feature_pca``'s ``pca_rgb`` is JAX's bit
for bit and its level features and rendering run, ``inspect_dataset``
prints what JAX's prints on the same synthetic Sintel tree, and the stress
tool holds its blocks and reports a finite spin."""

import contextlib
import io

import numpy as np
import pytest

from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    from video_depth_anything_torch.io.video import save_video

    path = str(tmp_path_factory.mktemp("examples") / "clip.mp4")
    yy, xx = np.mgrid[0:48, 0:64]
    frames = np.stack([np.stack([(xx * 4 + 9 * i) % 256, (yy * 5) % 256,
                                 (xx * yy + i) % 256], -1) for i in range(10)])
    save_video(frames.astype(np.uint8), path, fps=10)
    return path


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


def test_quickstart(clip, tmp_path):
    from video_depth_anything_torch.examples import quickstart
    from video_depth_anything_torch.io.video import read_video_frames

    out = str(tmp_path / "depth.mp4")
    text = _run(quickstart.main, [clip, "--output", out, "--input_size", "28", "--device", "cpu"])
    assert f"wrote {out} (10 frames)" in text
    frames, _ = read_video_frames(out)
    assert frames.shape == (10, 48, 64, 3) and frames.std() > 0


def test_pca_rgb_matches_jax():
    from examples.feature_pca import pca_rgb as jax_pca_rgb
    from video_depth_anything_torch.examples.feature_pca import pca_rgb

    feat = np.random.RandomState(3).randn(9, 11, 24).astype(np.float32)
    got = pca_rgb(feat)
    np.testing.assert_array_equal(got, jax_pca_rgb(feat))
    assert got.shape == (9, 11, 3) and got.min() >= 0 and got.max() <= 1


def test_feature_pca_features_and_rendering(clip, tmp_path):
    from video_depth_anything_torch.examples import feature_pca

    frames, feats = feature_pca.level_features(clip, "cpu", input_size=56)
    assert frames.shape == (2, 48, 64, 3)
    # levels 1-4 of vits at 56×70 (4×5 patches): 4×, 2×, 1× and ½× the grid,
    # vits's out_channels wide (the smallest map has the 3 rows a PCA needs)
    assert [f.shape for f in feats] == [(2, 16, 20, 48), (2, 8, 10, 96), (2, 4, 5, 192),
                                        (2, 2, 3, 384)]
    assert all(np.isfinite(f).all() for f in feats)
    out = str(tmp_path / "pca.png")
    text = _run(feature_pca.main, [clip, out, "--input_size", "56", "--device", "cpu"])
    assert "levels: 2x16x20x48, 2x8x10x96, 2x4x5x192, 2x2x3x384" in text
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_inspect_dataset_prints_what_jax_prints(tmp_path):
    import chip_smoke
    from examples import inspect_dataset as jax_example
    from video_depth_anything_torch.examples import inspect_dataset

    root = str(tmp_path / "sintel")
    chip_smoke.write_sintel(root, scenes=1, frames=6, h=40, w=64)
    outs = []
    for main, prefix in ((jax_example.main, "jax"), (inspect_dataset.main, "port")):
        text = _run(main, ["--dataset", "sintel", "--root", root,
                           "--out_prefix", str(tmp_path / prefix)])
        outs.append([ln.replace(str(tmp_path / prefix), "PREFIX") for ln in text.splitlines()])
    assert outs[0] == outs[1]
    assert any(ln.startswith("wrote PREFIX_") and ln.endswith(".gif") for ln in outs[1])
    assert any(ln.endswith("_cloud.png") for ln in outs[1])


def test_stress_tool_spins_and_reports():
    from video_depth_anything_torch.tools import stress

    gb = 64 * 64 * 64 * 2 / 2**30  # 64 blocks of 64² bf16
    text = _run(stress.main, ["--gb", str(gb), "--seconds", "0.2", "--size", "64",
                              "--device", "cpu"])
    assert "holding 64 x 64^2 bf16" in text
    line = next(ln for ln in text.splitlines() if ln.startswith("spun "))
    assert "TFLOP/s bf16" in line and line.endswith("finite True")
