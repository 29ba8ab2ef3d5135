"""The port's vitl VideoDepthAnything against the JAX module in fp32 on the
CPU, on the same noised weights (full vitl widths, encoder cut to 2
blocks).  Apart from ``test_torch_model.py`` so that each file stays near
30 s: building the vitl pair alone takes ~11 s on the CPU."""

import numpy as np
import pytest

from tests.torch_port_helpers import model_pair
from video_depth_anything_torch.ops.motion_module import motion_gate
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# The JAX package's own bound against the torch reference (docs/PARITY.md:12).
TOL = dict(rtol=1e-3, atol=2e-4)


@pytest.fixture(scope="module")
def pair():
    return model_pair("vitl", depth=2, seed=0)


def test_window_matches_jax(pair):
    """Rectangular 4×7 patch grid, B·T = 2."""
    jm, tm = pair
    x = np.random.RandomState(11).randn(1, 2, 56, 98, 3).astype(np.float32)
    want = np.asarray(jm.infer_window(x))
    got = tm.infer_window(x).numpy()
    assert got.shape == want.shape == (1, 2, 56, 98)
    np.testing.assert_allclose(got, want, **TOL)


def test_window_through_kernel_gates_matches_jax(pair):
    """322×322 frames, T = 8: 529 tokens over 16 heads take the flash gate
    and the 46×46 motion module m3 (C = 256) takes the fused gate; on the
    CPU both run their plain versions, which must still equal JAX's XLA
    path."""
    jm, tm = pair
    assert motion_gate(tm.cfg.motion, 256, 256, 8, 46, 46)
    x = np.random.RandomState(7).randn(1, 8, 322, 322, 3).astype(np.float32)
    want = np.asarray(jm.infer_window(x))
    got = tm.infer_window(x).numpy()
    np.testing.assert_allclose(got, want, **TOL)
