"""The fp32 Kernel C's plan (``csrc/motion_module_f32.cu``) at frame counts
it pads, T = 12, 20 and 24 (Tp = 16, 32 and 32 rows a location: rows t ≥ T
zero, their keys masked, no APE, neither their y nor their output written
to device memory), emulated in torch (``tests/test_torch_fp32.py``:
``emulate_motion_f32``) against the JAX Pallas motion kernel in interpret
mode on fp32 inputs; with the padded frames' keys unmasked the plan misses
the plain version.  Apart from ``test_torch_motion_f32_tiling.py`` so that
pytest-xdist's workers (``--dist loadfile``) share the interpret-mode runs."""

import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_fp32 import FP32_TOL, emulate_motion_f32, rel
from tests.test_torch_motion_f32_tiling import MUTANT_TOL, _case
from tests.torch_port_helpers import one_torch_thread  # noqa: F401
from video_depth_anything_torch.config import MotionModuleConfig as TCfg
from video_depth_anything_tpu.config import MotionModuleConfig as JCfg
from video_depth_anything_tpu.ops.pallas_motion import fused_motion_module

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("c,t,s", [(64, 12, 9), (64, 20, 5), (128, 24, 3)])
def test_motion_f32_padded_plan_matches_jax_kernel(c, t, s):
    x, p, plain = _case(c, t, s)
    want = np.asarray(fused_motion_module(jnp.asarray(x.numpy()),
                                          {k: jnp.asarray(v.numpy()) for k, v in p.items()},
                                          heads=8, cfg=JCfg(), interpret=True))
    assert rel(emulate_motion_f32(x, p, TCfg(), 8), want, x) <= FP32_TOL
    assert rel(emulate_motion_f32(x, p, TCfg(), 8, mutant="unmasked_keys"), plain, x) > MUTANT_TOL
