"""The port's VideoDepthAnything, encoder and window forward against the
JAX module in fp32 on the CPU, on the same noised weights (vits widths,
encoder cut to 4 blocks)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import configs, jax_param_shapes, model_pair, noised_params
from video_depth_anything_torch.io.checkpoint import from_jax_params
from video_depth_anything_torch.models.vda import VDAModel
from video_depth_anything_torch.ops import temporal_attention as t_temporal
from video_depth_anything_tpu.models.vda import VDAModel as JaxVDA
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# The JAX package's own bound against the torch reference (docs/PARITY.md:12).
TOL = dict(rtol=1e-3, atol=2e-4)


@pytest.fixture(scope="module")
def pair():
    return model_pair("vits", depth=4, seed=0)


@pytest.mark.parametrize("shape,skip", [
    ((1, 4, 70, 70, 3), False),    # square, 5×5 patches: pos-embed interpolation
    ((2, 3, 56, 98, 3), False),    # rectangular 4×7 grid, B·T = 6
    ((1, 2, 56, 56, 3), True),     # skip_tmp_block
])
def test_window_matches_jax(pair, shape, skip):
    jm, tm = pair
    x = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    want = np.asarray(jm.infer_window(x, skip_tmp_block=skip))
    got = tm.infer_window(x, skip_tmp_block=skip).numpy()
    assert got.shape == want.shape == shape[:4]
    np.testing.assert_allclose(got, want, **TOL)


def test_window_through_kernel_gates_matches_jax(pair):
    """322×322 frames, T = 8: 529 tokens take the flash gate and the 46×46
    motion module (m3) takes the fused gate; on the CPU both run their
    plain versions, which must still equal JAX's XLA path."""
    jm, tm = pair
    x = np.random.RandomState(7).randn(1, 8, 322, 322, 3).astype(np.float32)
    want = np.asarray(jm.infer_window(x))
    got = tm.infer_window(x).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_encoder_taps_match_jax(pair):
    jm, tm = pair
    x = np.random.RandomState(5).randn(2, 42, 84, 3).astype(np.float32)
    want = jm.module.apply({"params": jm.params}, jnp.asarray(x), jm.cfg.intermediate_layer_idx,
                           method=lambda m, x, idx: m.pretrained(x, idx))
    with torch.no_grad():
        got = tm.module.pretrained(torch.from_numpy(x), tm.cfg.intermediate_layer_idx)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VDAModel("vits")


def test_frame_size_must_be_patch_multiple(pair):
    _, tm = pair
    with pytest.raises(ValueError):
        tm.infer_window(np.zeros((1, 2, 30, 28, 3), np.float32))


def test_window_under_pallas_matches_jax(monkeypatch):
    """``attn_impl="pallas"`` in both packages on the same noised weights
    (vits widths, 4 encoder blocks; 70×70 frames, T = 8): every motion
    module takes the temporal gate with ``auto=False``, so m1 (C = 384,
    d = 48), which ``auto`` leaves to the einsum, goes through Kernel B's
    wrapper too (its plain version on CPU tensors; JAX off the TPU takes
    its einsum)."""
    jc, tc = configs("vits", 4)
    jm = JaxVDA(cfg=jc, dtype=jnp.float32, attn_impl="pallas")
    jm.params = noised_params(jax_param_shapes(jm.module, jnp.zeros((1, 2, 28, 28, 3))), 3)
    tm = VDAModel(cfg=tc, device="cpu", dtype=torch.float32, attn_impl="pallas")
    tm.load_state_dict(from_jax_params(jm.params, jc), strict=True)
    widths = []
    wrapper = t_temporal.temporal_attention

    def counted(q, k, v, heads, scale):
        widths.append(q.shape[-1] // heads)
        return wrapper(q, k, v, heads, scale)

    monkeypatch.setattr(t_temporal, "temporal_attention", counted)
    x = np.random.RandomState(9).randn(1, 8, 70, 70, 3).astype(np.float32)
    want = np.asarray(jm.infer_window(x))
    got = tm.infer_window(x).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert sorted(set(widths)) == [8, 24, 48] and len(widths) == 8  # 2 attentions × 4 modules
