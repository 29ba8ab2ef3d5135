"""The port's resize, scale/shift and preprocessing ops against the JAX
package's functions on the same seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_depth_anything_torch.ops import resize as t_resize
from video_depth_anything_torch.ops import scale_shift as t_ss
from video_depth_anything_torch.utils import transform as t_tf
from video_depth_anything_tpu.ops import resize as j_resize
from video_depth_anything_tpu.ops import scale_shift as j_ss
from video_depth_anything_tpu.utils import transform as j_tf
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("src,dst", [((4, 7), (8, 14)), ((37, 66), (74, 132)),
                                     ((296, 296), (518, 518)), ((9, 5), (4, 3))])
def test_bilinear_resize_matches_jax(src, dst):
    x = np.random.RandomState(0).randn(2, *src, 3).astype(np.float32)
    want = np.asarray(j_resize.bilinear_resize(jnp.asarray(x), *dst))
    got = t_resize.bilinear_resize(torch.from_numpy(x), *dst).numpy()
    # fp32 interpolation in both; the JAX form is a GEMM (summation order)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bilinear_resize_in_chunks_matches_jax(monkeypatch):
    """A batch whose output passes the element limit is resized in chunks
    of frames (the limit cut here to 2.5 frames' worth), to the same
    values."""
    x = np.random.RandomState(4).randn(7, 5, 6, 3).astype(np.float32)
    monkeypatch.setattr(t_resize, "_MAX_ELEMENTS", 5 * 9 * 8 * 3 // 2)
    got = t_resize.bilinear_resize(torch.from_numpy(x), 9, 8)
    want = np.asarray(j_resize.bilinear_resize(jnp.asarray(x), 9, 8))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("out_hw", [(5, 5), (4, 7), (37, 66)])
def test_bicubic_pos_embed_resize_matches_jax(out_hw):
    grid = 37
    pos = np.random.RandomState(1).randn(grid, grid, 8).astype(np.float32)
    sh, sw = ((n + 0.1) / grid for n in out_hw)
    want = np.asarray(j_resize.bicubic_pos_embed_resize(jnp.asarray(pos), *out_hw, sh, sw))
    got = t_resize.bicubic_pos_embed_resize(torch.from_numpy(pos), *out_hw, sh, sw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bilinear_resize_np_equals_jax_host_resize():
    x = np.random.RandomState(2).rand(3, 37, 66).astype(np.float32)
    np.testing.assert_array_equal(t_resize.bilinear_resize_np(x, 480, 854),
                                  j_resize.bilinear_resize_np(x, 480, 854))


def test_scale_shift_matches_jax():
    rng = np.random.RandomState(3)
    pred = rng.rand(2, 30, 40).astype(np.float32)
    target = 2.5 * pred + 0.3 + 0.01 * rng.randn(*pred.shape).astype(np.float32)
    mask = (rng.rand(*pred.shape) > 0.2).astype(np.float32)
    for kw in ({}, {"mask": mask}, {"mask": mask, "scale_only": True}):
        assert t_ss.compute_scale_and_shift(pred, target, **kw) == \
            j_ss.compute_scale_and_shift(pred, target, **kw)
    for n in (1, 2, 8):
        np.testing.assert_array_equal(t_ss.interpolation_weights(n), j_ss.interpolation_weights(n))


@pytest.mark.parametrize("hw", [(480, 854), (480, 480), (720, 1280), (100, 300)])
def test_model_size_matches_jax(hw):
    assert t_tf.model_size_for(*hw) == j_tf.model_size_for(*hw)
    assert t_tf.effective_input_size(*hw) == j_tf.effective_input_size(*hw)


def test_preprocess_matches_jax_cv2_path(monkeypatch):
    monkeypatch.setenv("VDA_NATIVE_PREPROC", "0")
    frames = np.random.RandomState(4).randint(0, 255, (3, 48, 64, 3), dtype=np.uint8)
    np.testing.assert_array_equal(t_tf.preprocess_frames(frames, 56),
                                  j_tf.preprocess_frames(frames, 56))
