"""Kernel C's Hopper plan (``csrc/motion_module.cuh``) at frame counts it
pads, T = 12, 20 and 24 (Tp = 16, 32 and 32 rows a location: rows t ≥ T
zero, their keys masked, no APE, never stored), emulated in torch
(``tests/test_torch_motion_tiling.py``: ``emulate``) against the JAX Pallas
motion kernel run in interpret mode.  Apart from that file so that
pytest-xdist's workers (``--dist loadfile``) share the interpret-mode runs
(about 20 s a shape)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_motion_tiling import TOL, _case, _rel
from tests.torch_port_helpers import one_torch_thread  # noqa: F401
from video_depth_anything_tpu.config import MotionModuleConfig as JCfg
from video_depth_anything_tpu.ops.pallas_motion import fused_motion_module

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("c,t,s", [(64, 12, 12), (64, 20, 5), (256, 24, 3)])
def test_padded_tiling_matches_pallas_kernel(c, t, s):
    p, x, got = _case(c, t, s)
    want = fused_motion_module(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                               {k: jnp.asarray(v.numpy()) for k, v in p.items()},
                               heads=8, cfg=JCfg(), interpret=True)
    assert _rel(got, torch.from_numpy(np.asarray(want, np.float32)), x) <= TOL
