"""The port's vitb VideoDepthAnything against the JAX module in fp32 on the
CPU, on the same noised weights (full vitb widths, encoder cut to 2
blocks).  Apart from ``test_torch_model.py`` so that each file stays near
30 s."""

import numpy as np
import pytest

from tests.torch_port_helpers import model_pair
from video_depth_anything_torch.ops.motion_module import motion_gate
from video_depth_anything_torch.ops.temporal_attention import temporal_gate
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# The JAX package's own bound against the torch reference (docs/PARITY.md:12).
TOL = dict(rtol=1e-3, atol=2e-4)


@pytest.fixture(scope="module")
def pair():
    return model_pair("vitb", depth=2, seed=0)


def test_window_matches_jax(pair):
    """Rectangular 4×7 patch grid, B·T = 6."""
    jm, tm = pair
    x = np.random.RandomState(12).randn(2, 3, 56, 98, 3).astype(np.float32)
    want = np.asarray(jm.infer_window(x))
    got = tm.infer_window(x).numpy()
    assert got.shape == want.shape == (2, 3, 56, 98)
    np.testing.assert_allclose(got, want, **TOL)


def test_window_through_kernel_gates_matches_jax(pair):
    """322×322 frames, T = 8: 529 tokens over 12 heads take the flash gate,
    the 23×23 module m2 (C = 128, d = 16) Kernel B's gate and the 46×46
    module m3 (C = 128) the fused gate; on the CPU each runs its plain
    version, which must still equal JAX's XLA path."""
    jm, tm = pair
    assert temporal_gate((1, 8, 23 * 23, 128), 8)
    assert motion_gate(tm.cfg.motion, 128, 128, 8, 46, 46)
    x = np.random.RandomState(8).randn(1, 8, 322, 322, 3).astype(np.float32)
    want = np.asarray(jm.infer_window(x))
    got = tm.infer_window(x).numpy()
    np.testing.assert_allclose(got, want, **TOL)
