"""The port's CLI in feature-cache and KV-cache streaming mode on the CPU:
depth of the frame count the JAX pipeline returns for the same flags,
``--original`` precedence, the refusal of a KV window longer than the
position table, and the card-side refusal of ``--attn_impl pallas``."""

import cv2
import numpy as np
import pytest

from tests.torch_port_helpers import one_torch_thread  # noqa: F401
from video_depth_anything_torch import run
from video_depth_anything_torch.ops.attention import parse_attn_impl

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, H, W = 14, 48, 64
LENGTH = 6


@pytest.fixture(scope="module")
def clip(tmp_path_factory, one_torch_thread):
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
    # KV cache: the warm-up window's depths, then one per step (chunks of 4
    # and a remainder), every frame; --keyframe_list is ignored
    (("--process_single_image", "--kv_cache", "--stream_chunk", "4"), N),
    # KV cache aligned, fp16 transfer: every frame
    (("--process_single_image", "--kv_cache", "--align_each_new_frame", "--transfer_dtype",
      "fp16", "--stream_chunk", "1"), N),
])
def test_cli_streaming_on_cpu(clip, tmp_path, flags, frames):
    depth = _run(clip, tmp_path, *flags)
    assert depth.shape == (frames, H, W) and np.isfinite(depth).all()


def test_kv_cache_is_refused(clip, tmp_path):
    """A KV window longer than the APE table (temporal_max_len 32) has no
    positions for its slots."""
    with pytest.raises(ValueError, match="temporal_max_len"):
        run.main(["--input_video", clip, "--output_dir", str(tmp_path), "--random_init",
                  "--device", "cpu", "--fp32", "--input_size", "28", "--process_single_image",
                  "--kv_cache", "--inference_length", "33"])


@pytest.mark.parametrize("impl", ["pallas", "pallas:fast"])
def test_pallas_is_refused_on_the_card(impl):
    """The card took ``pallas`` once Kernel B covered every head width of the
    JAX gate (d = 8 to 128): it now parses as on the CPU, not refused."""
    want = ("pallas", impl.endswith(":fast"))
    assert parse_attn_impl(impl, "cuda") == want
    assert parse_attn_impl(impl, "cpu") == want
