"""The port's vitg VideoDepthAnything against the JAX module in fp32 on the
CPU, on the same noised weights: vitg's widths (embed 1536, 24 heads of 64,
the SwiGLU feed-forward, features 384, out_channels 1536) with the encoder
cut to 4 blocks tapped at (0, 1, 2, 3), at a tiny frame size.  Also the
dispatch points it reaches on the card: Kernel A at 24 heads of 64, Kernel
C at C = 384 on m3, Kernel B at d = 48 on m2 under ``pallas``."""

import numpy as np
import pytest

from tests.torch_port_helpers import model_pair
from tests.torch_port_helpers import one_torch_thread  # noqa: F401
from video_depth_anything_torch.ops.flash_attention import flash_gate
from video_depth_anything_torch.ops.motion_module import motion_gate
from video_depth_anything_torch.ops.temporal_attention import temporal_gate

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# The JAX package's own bound against the torch reference (docs/PARITY.md:12).
TOL = dict(rtol=1e-3, atol=2e-4)


@pytest.fixture(scope="module")
def pair():
    return model_pair("vitg", depth=4, seed=3)


def test_vitg_config_matches_jax(pair):
    jm, tm = pair
    for cfg in (jm.cfg, tm.cfg):
        assert (cfg.vit.embed_dim, cfg.vit.num_heads, cfg.vit.ffn_layer) == (1536, 24,
                                                                              "swiglufused")
        assert (cfg.features, cfg.out_channels) == (384, (1536,) * 4)
        assert cfg.intermediate_layer_idx == (0, 1, 2, 3)
    assert tm.module.pretrained.blocks[0].mlp.w12.weight.shape[0] == 2 * 4096


def test_vitg_window_matches_jax(pair):
    """A 2×3 patch grid, B·T = 4."""
    jm, tm = pair
    x = np.random.RandomState(19).randn(2, 2, 28, 42, 3).astype(np.float32)
    want = np.asarray(jm.infer_window(x))
    got = tm.infer_window(x).numpy()
    assert got.shape == want.shape == (2, 2, 28, 42)
    np.testing.assert_allclose(got, want, **TOL)


def test_vitg_window_gates():
    """The shapes a vitg 518² window gives the gates: Kernel A at 24 heads
    of 64 (1370 tokens), Kernel C at C = 384 on 74² locations, Kernel B at
    d = 48 on m2 under ``pallas`` only; m0 (C = 1536, d = 192) nowhere."""
    from video_depth_anything_torch.config import get_model_config

    mcfg = get_model_config("vitg").motion
    assert flash_gate((32, 1370, 24, 64)) and flash_gate((32, 2443, 24, 64))
    assert motion_gate(mcfg, 384, 384, 32, 74, 74)
    assert not motion_gate(mcfg, 384, 384, 32, 37, 37)
    assert temporal_gate((1, 32, 1369, 384), 8, auto=False)
    assert not temporal_gate((1, 32, 1369, 384), 8, auto=True)
    assert not motion_gate(mcfg, 1536, 1536, 32, 37, 66)
    assert not temporal_gate((1, 32, 1369, 1536), 8, auto=False)
