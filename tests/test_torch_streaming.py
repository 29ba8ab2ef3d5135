"""Feature-cache streaming pieces against the JAX package on the CPU: the
gather schedule and slot tables, the device scale/shift fit, the
refusals, and the streaming methods of ``VideoDepthAnything`` against
``module.apply(..., method=...)`` on the same noised weights in fp32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import model_pair
from video_depth_anything_torch.inference import streaming as t_stream
from video_depth_anything_torch.ops.scale_shift import compute_scale_and_shift_torch
from video_depth_anything_tpu.inference import streaming as j_stream
from video_depth_anything_tpu.ops.scale_shift import compute_scale_and_shift_jax
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# The JAX package's own bound against the torch reference (docs/PARITY.md:12).
TOL = dict(rtol=1e-3, atol=2e-4)
CONFIGS = [(32, (20,)), (32, (0, 12)), (8, (0, 4)), (6, (2,)), (12, (1, 3, 5))]


@pytest.mark.parametrize("length,keyframes", CONFIGS)
def test_schedule_equals_jax(length, keyframes):
    assert t_stream.streaming_schedule(length, keyframes) == \
        j_stream.streaming_schedule(length, keyframes)


class _Model:
    """What the pipelines' constructors read of a model."""
    device = torch.device("cpu")


@pytest.mark.parametrize("length,keyframes", CONFIGS)
@pytest.mark.parametrize("chunk", [1, 3, 8])
@pytest.mark.parametrize("aligned", [False, True])
def test_slot_tables_equal_jax(length, keyframes, chunk, aligned):
    """``_steady_indices`` (with its in-chunk redirects) or
    ``_aligned_steady_indices`` over three chunks, and the chunk clamp."""
    jp = j_stream.StreamingDepthPipeline(None, inference_length=length, keyframe_list=keyframes,
                                         chunk_size=chunk)
    tp = t_stream.StreamingDepthPipeline(_Model(), inference_length=length,
                                         keyframe_list=keyframes, chunk_size=chunk)
    assert tp.chunk == jp.chunk and tp.cache_len == jp.cache_len
    name = "_aligned_steady_indices" if aligned else "_steady_indices"
    pj = pt = list(range(jp.cache_len))
    for _ in range(3):
        *want, pj = getattr(jp, name)(pj, jp.chunk)
        *got, pt = getattr(tp, name)(pt, tp.chunk)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert pt == pj
    if not aligned:
        assert len(set(got[1].tolist())) == len(got[1])  # distinct write slots


@pytest.mark.parametrize("case", ["random", "masked", "singular"])
def test_device_fit_matches_jax(case):
    rng = np.random.RandomState(0)
    pred = rng.rand(2, 36, 44).astype(np.float32) * 3
    target = pred * 1.7 + 0.3 + rng.randn(2, 36, 44).astype(np.float32) * 0.05
    mask = None
    if case == "masked":
        mask = (rng.rand(2, 36, 44) > 0.3).astype(np.float32)
    if case == "singular":
        pred = np.full_like(pred, 0.5)  # det == 0 → (1, 0)
    want = compute_scale_and_shift_jax(jnp.asarray(pred), jnp.asarray(target),
                                       None if mask is None else jnp.asarray(mask))
    got = compute_scale_and_shift_torch(torch.from_numpy(pred), torch.from_numpy(target),
                                        None if mask is None else torch.from_numpy(mask))
    # fp32 sums over 3168 pixels in another order; t comes out of a
    # difference of products of those sums (cancellation), hence atol
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-4, atol=1e-4)
    if case == "singular":
        assert (float(got[0]), float(got[1])) == (1.0, 0.0)


def test_align_with_a_zero_keyframe_is_refused():
    with pytest.raises(ValueError, match="unfilled cache slots"):
        t_stream.StreamingDepthPipeline(_Model(), inference_length=8, keyframe_list=(0, 4),
                                        align_each_new_frame=True)


@pytest.mark.parametrize("kwargs,error", [
    (dict(ring_dtype="fp8"), ValueError),
    (dict(transfer_dtype="bf16"), ValueError),
])
def test_refused_options(kwargs, error):
    with pytest.raises(error):
        t_stream.StreamingDepthPipeline(_Model(), inference_length=8, keyframe_list=(4,), **kwargs)


def test_warmup_false_is_refused():
    pipe = t_stream.StreamingDepthPipeline(_Model(), inference_length=8, keyframe_list=(4,))
    with pytest.raises(NotImplementedError):
        pipe.infer(np.zeros((2, 28, 28, 3), np.uint8), warmup=False)


def test_host_upsample_is_off_with_align():
    pipe = t_stream.StreamingDepthPipeline(_Model(), inference_length=8, keyframe_list=(4,),
                                           align_each_new_frame=True, host_upsample=True)
    assert not pipe.host_upsample


# -- the model's streaming methods against the JAX module ----------------------

H, W, T = 42, 56, 6  # 3×4 patches; a window of T frames


@pytest.fixture(scope="module")
def pair():
    return model_pair("vits", depth=2, seed=5)


def _apply(jm, method, *args, **kwargs):
    """``module.apply(..., method=method)``, jitted (one compile is far
    cheaper than the op-by-op dispatch of a first unjitted call)."""
    fn = jax.jit(lambda params, *a: jm.module.apply({"params": params}, *a, method=method,
                                                    **kwargs))
    return fn(jm.params, *(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args))


def _levels(pair, n, seed):
    """Level features of ``n`` random frames, from the JAX encoder."""
    jm, _ = pair
    x = np.random.RandomState(seed).randn(n, H, W, 3).astype(np.float32)
    return tuple(np.array(f) for f in _apply(jm, "encode_level_features", x))


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_encode_level_features_matches_jax(pair):
    jm, tm = pair
    x = np.random.RandomState(1).randn(3, H, W, 3).astype(np.float32)
    want = _apply(jm, "encode_level_features", x)
    with torch.no_grad():
        got = tm.module.encode_level_features(torch.from_numpy(x))
    assert [g.shape for g in got] == [w.shape for w in want]
    _close(got, want)


@pytest.mark.parametrize("pred_idx,skip", [(None, False), ((0, 2), False),
                                           (tuple(range(T - 1)), True)])
def test_streaming_step_matches_jax(pair, pred_idx, skip):
    jm, tm = pair
    cached = _levels(pair, T - 1, seed=2)
    x = np.random.RandomState(3).randn(1, H, W, 3).astype(np.float32)
    want_depth, want_new = _apply(jm, "streaming_step", x, tuple(map(jnp.asarray, cached)),
                                  pred_idx=pred_idx, skip_tmp_block=skip)
    with torch.no_grad():
        depth, new = tm.module.streaming_step(torch.from_numpy(x),
                                              tuple(map(torch.from_numpy, cached)),
                                              pred_idx=pred_idx, skip_tmp_block=skip)
    assert depth.shape == want_depth.shape == (1 + len(pred_idx or ()), H, W)
    _close((depth,) + tuple(new), (want_depth,) + tuple(want_new))


def test_streaming_head_step_matches_jax(pair):
    jm, tm = pair
    cached = _levels(pair, T - 1, seed=4)
    levels = _levels(pair, 1, seed=5)
    want_depth, _ = _apply(jm, "streaming_head_step", tuple(map(jnp.asarray, levels)),
                           tuple(map(jnp.asarray, cached)), pred_idx=(1, 3))
    with torch.no_grad():
        depth, _ = tm.module.streaming_head_step(tuple(map(torch.from_numpy, levels)),
                                                 tuple(map(torch.from_numpy, cached)),
                                                 pred_idx=(1, 3))
    _close((depth,), (want_depth,))


def test_streaming_chunk_step_matches_jax(pair):
    """K = 3 frames over a cache of 7; gather positions ≥ 7 read frames of
    the same chunk."""
    jm, tm = pair
    cache = _levels(pair, 7, seed=6)
    x = np.random.RandomState(7).randn(3, H, W, 3).astype(np.float32)
    gather = np.array([[0, 2, 3, 4, 5], [0, 3, 4, 5, 7], [0, 4, 5, 7, 8]], np.int32)
    want_depth, want_new = _apply(jm, "streaming_chunk_step", x, tuple(map(jnp.asarray, cache)),
                                  jnp.asarray(gather))
    with torch.no_grad():
        depth, new = tm.module.streaming_chunk_step(
            torch.from_numpy(x), tuple(map(torch.from_numpy, cache)),
            torch.from_numpy(gather.astype(np.int64)))
    assert depth.shape == (3, H, W)
    _close((depth,) + tuple(new), (want_depth,) + tuple(want_new))
