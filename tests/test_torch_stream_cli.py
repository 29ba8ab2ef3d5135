"""The port's CLI in feature-cache streaming mode on the CPU: depth of the
frame count the JAX pipeline returns for the same flags, ``--original``
precedence, the refusal of ``--kv_cache``, and the card-side refusal of
``--attn_impl pallas``."""

import cv2
import numpy as np
import pytest

from video_depth_anything_torch import run
from video_depth_anything_torch.ops.attention import parse_attn_impl

N, H, W = 14, 48, 64
LENGTH = 6


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clip") / "clip.mp4")
    yy, xx = np.mgrid[0:H, 0:W]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (W, H))
    for i in range(N):
        f = np.zeros((H, W, 3), np.uint8)
        f[..., 0] = (xx * 4 + i * 3) % 256
        f[..., 1] = (yy * 5) % 256
        writer.write(f)
    writer.release()
    return path


def _run(clip, tmp_path, *flags):
    rc = run.main(["--input_video", clip, "--output_dir", str(tmp_path), "--random_init",
                   "--device", "cpu", "--fp32", "--input_size", "28", "--save_npz",
                   "--inference_length", str(LENGTH), "--keyframe_list", "2", *flags])
    assert rc == 0
    return np.load(tmp_path / "clip_depth.npz")["depth"]


@pytest.mark.parametrize("flags,frames", [
    # plain: no depth for the first L − 1 frames (the JAX pipeline's quirk)
    (("--process_single_image", "--stream_chunk", "4", "--attn_impl", "auto:fast"),
     N - LENGTH + 1),
    # aligned: frame 0 serves the fit only
    (("--process_single_image", "--align_each_new_frame", "--ring_dtype", "fp16",
      "--transfer_dtype", "fp16"), N - 1),
    # --original overrides the streaming flags: the sliding window, every frame
    (("--process_single_image", "--original", "--attn_impl", "xla"), N),
])
def test_cli_streaming_on_cpu(clip, tmp_path, flags, frames):
    depth = _run(clip, tmp_path, *flags)
    assert depth.shape == (frames, H, W) and np.isfinite(depth).all()


def test_kv_cache_is_refused(clip, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run.main(["--input_video", clip, "--output_dir", str(tmp_path), "--random_init",
                  "--device", "cpu", "--process_single_image", "--kv_cache"])


@pytest.mark.parametrize("impl", ["pallas", "pallas:fast"])
def test_pallas_is_refused_on_the_card(impl):
    with pytest.raises(NotImplementedError, match="Kernel B"):
        parse_attn_impl(impl, "cuda")
    assert parse_attn_impl(impl, "cpu")[0] == "pallas"
