"""The port's KV-cache motion-module steps against the JAX package on the
CPU, in fp32 on the same noised weights (as tests/test_kv_cache.py pins
the JAX side): ``collect`` and ``kv_step`` with APE and RoPE, one query
frame or the pinned anchor plus the newest frame; the RoPE ``kv_step``
over the caches of frames 0..T−2 equals the last frame of full attention;
only the full-window attention reaches Kernel B's dispatch point; an
unknown position type raises."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import jax_param_shapes, noised_params
from video_depth_anything_torch.config import MotionModuleConfig as TCfg
from video_depth_anything_torch.io.checkpoint import motion_module_state
from video_depth_anything_torch.models import temporal as t_temporal
from video_depth_anything_torch.ops.dispatch import plain_reference
from video_depth_anything_torch.ops.temporal_attention import temporal_attention_plain
from video_depth_anything_tpu.config import MotionModuleConfig as JCfg
from video_depth_anything_tpu.models.temporal import TemporalModule as JModule
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# fp32 parity bound of the JAX package against the torch reference
# (docs/PARITY.md:12).
TOL = dict(rtol=1e-3, atol=2e-4)
C, T, H, W = 64, 8, 3, 5


def _flat(caches):
    if isinstance(caches, torch.Tensor):
        return [caches.numpy()]
    return [a for c in caches for a in _flat(c)]


def _to_torch(caches):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), caches)


def _module_pair(pe: str, seed: int):
    jmod = JModule(JCfg(pos_embedding_type=pe), C, "xla")
    params = noised_params(jax_param_shapes(jmod, jnp.zeros((1, T, H, W, C))), seed)
    tcfg = TCfg(pos_embedding_type=pe)
    tmod = t_temporal.TemporalModule(tcfg, C)
    # strict: the JAX export writes pos_encoder.pe for RoPE modules too
    tmod.load_state_dict({k: torch.from_numpy(v)
                          for k, v in motion_module_state(params, tcfg).items()}, strict=True)
    return jmod, params, tmod


@pytest.mark.parametrize("pe", ["ape", "rope"])
def test_collect_matches_jax(pe):
    jmod, params, tmod = _module_pair(pe, seed=11)
    x = np.random.RandomState(1).randn(1, T, H, W, C).astype(np.float32)
    want_y, want_c = jmod.apply({"params": params}, jnp.asarray(x), method="collect")
    with torch.no_grad():
        got_y, got_c = tmod.collect(torch.from_numpy(x))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    want_leaves = jax.tree_util.tree_leaves(want_c)
    assert len(_flat(got_c)) == len(want_leaves) == 4
    for g, w in zip(_flat(got_c), want_leaves):
        assert g.shape == (1, T, H * W, C)
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


@pytest.mark.parametrize("pe", ["ape", "rope"])
@pytest.mark.parametrize("pin,nq", [(False, 1), (True, 2)])
def test_kv_step_matches_jax(pe, pin, nq):
    """From the same caches of T − 1 frames: the newest frame alone, or the
    pinned anchor (window slot 0) and the newest frame (the last slot)."""
    jmod, params, tmod = _module_pair(pe, seed=12 + nq)
    rng = np.random.RandomState(2)
    x = rng.randn(1, T - 1, H, W, C).astype(np.float32)
    x_new = rng.randn(1, nq, H, W, C).astype(np.float32)
    _, caches = jmod.apply({"params": params}, jnp.asarray(x), method="collect")
    want_y, want_c = jmod.apply({"params": params}, jnp.asarray(x_new), caches, pin_anchor=pin,
                                method="kv_step")
    with torch.no_grad():
        got_y, got_c = tmod.kv_step(torch.from_numpy(x_new), _to_torch(caches), pin)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    for g, w in zip(_flat(got_c), jax.tree_util.tree_leaves(want_c)):
        assert g.shape == (1, T - 1, H * W, C)
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


def test_kv_step_rope_positions_stay_relative():
    """RoPE: the caches are unrotated and rotated per current slot at
    attend time, so a kv_step over the caches of frames 0..T−2 equals the
    last frame of full attention over all T frames."""
    dim, t, s = 32, 5, 3
    attn = t_temporal.TemporalSelfAttention(
        TCfg(num_heads=4, temporal_max_len=8, pos_embedding_type="rope"), dim)
    rng = np.random.RandomState(3)
    with torch.no_grad():
        for lin in (attn.to_q, attn.to_k, attn.to_v, attn.to_out[0]):
            lin.weight.copy_(torch.from_numpy(rng.randn(dim, dim).astype(np.float32) / dim**0.5))
        attn.to_out[0].bias.copy_(torch.from_numpy(0.1 * rng.randn(dim).astype(np.float32)))
        x = torch.from_numpy(rng.randn(1, t, s, dim).astype(np.float32))
        full = attn(x)
        _, kf, vf = attn.call_collect(x[:, : t - 1])
        out, k2, v2 = attn.kv_step(x[:, t - 1:], kf, vf)
    torch.testing.assert_close(out[:, 0], full[:, -1], rtol=1e-5, atol=1e-5)
    assert k2.shape == kf.shape
    # the caches hold position-free values: the newest frame's to_v(x)
    torch.testing.assert_close(v2[:, -1], attn.to_v(x[:, -1]), rtol=1e-5, atol=1e-6)


def test_only_full_window_attention_reaches_kernel_b(monkeypatch):
    """``collect`` never takes the fused module but sends its attentions
    through Kernel B's dispatch point where the gate admits them; a
    ``kv_step`` (fewer query frames than keys) never does."""
    calls = []

    class Spy:
        @staticmethod
        def apply(q, k, v, heads, scale):
            calls.append((tuple(q.shape), tuple(k.shape)))
            return temporal_attention_plain(q, k, v, heads, scale)

    monkeypatch.setattr(t_temporal, "TemporalAttentionFn", Spy)
    _, _, tmod = _module_pair("ape", seed=13)
    x = torch.from_numpy(np.random.RandomState(4).randn(1, T, H, W, C).astype(np.float32))
    with torch.no_grad():
        _, caches = tmod.collect(x)
        assert calls == [((1, T, H * W, C),) * 2] * 2
        calls.clear()
        tmod.kv_step(x[:, -1:], jax.tree_util.tree_map(lambda c: c[:, 1:], caches))
        tmod.kv_step(x[:, :2], jax.tree_util.tree_map(lambda c: c[:, 1:], caches), True)
        with plain_reference():
            tmod.collect(x)
    assert calls == []


def test_unknown_position_type_raises():
    with pytest.raises(ValueError, match="pos_embedding_type"):
        t_temporal.TemporalModule(TCfg(pos_embedding_type="alibi"), C)
