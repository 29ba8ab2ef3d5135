"""Which module takes which kernel on the vits main path, at 518×518 and
518×924, in the port and in the JAX package.

The JAX side runs the JAX package's own gate functions with the kernels
they would launch replaced by tags (and, for the temporal gate, a device
list that says TPU), so the expected plan is derived from the JAX gates
themselves.  Pure Python: nothing is computed."""

import jax
import numpy as np
import pytest

from video_depth_anything_torch.config import get_model_config
from video_depth_anything_torch.ops.flash_attention import flash_gate
from video_depth_anything_torch.ops.motion_module import motion_gate
from video_depth_anything_torch.ops.temporal_attention import temporal_gate
from video_depth_anything_tpu.config import MotionModuleConfig as JCfg
from video_depth_anything_tpu.ops import pallas_attention, pallas_motion, pallas_temporal


class _Tag(str):
    def reshape(self, *shape):
        return self


class _FakeTPU:
    platform = "tpu"


def _module_shapes(h, w):
    """(name, h, w, C) of the four vits motion modules for one frame size."""
    cfg = get_model_config("vits")
    ph, pw = h // 14, w // 14
    oc, f = cfg.out_channels, cfg.features
    return [("m0", ph, pw, oc[2]), ("m1", (ph + 1) // 2, (pw + 1) // 2, oc[3]),
            ("m2", ph, pw, f), ("m3", 2 * ph, 2 * pw, f)]


def port_plan(h, w):
    cfg = get_model_config("vits")
    heads = cfg.motion.num_heads
    n = (h // 14) * (w // 14) + 1
    plan = {"vit": "flash_attention" if flash_gate((32, n, 6, 64)) else "plain"}
    for name, mh, mw, c in _module_shapes(h, w):
        if motion_gate(cfg.motion, c, c, 32, mh, mw):
            plan[name] = "motion_module"
        elif temporal_gate((1, 32, mh * mw, c), heads):
            plan[name] = "temporal_attention"
        else:
            plan[name] = "plain"
    return plan


def jax_plan(h, w, monkeypatch):
    monkeypatch.setattr(pallas_attention, "flash_attention_native",
                        lambda *a, **k: _Tag("flash_attention"))
    monkeypatch.setattr(pallas_attention, "spatial_flash_attention",
                        lambda *a, **k: _Tag("flash_attention"))
    monkeypatch.setattr(pallas_temporal, "temporal_attention_window",
                        lambda *a, **k: _Tag("temporal_attention"))
    monkeypatch.setattr(pallas_motion, "fused_motion_module",
                        lambda *a, **k: _Tag("motion_module"))
    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeTPU()])
    cfg, heads = JCfg(), JCfg().num_heads
    n = (h // 14) * (w // 14) + 1
    q = np.empty((32, n, 6, 64), np.uint8)
    plan = {"vit": pallas_attention.try_spatial_attention(q, q, q, 0.125) or "plain"}
    for name, mh, mw, c in _module_shapes(h, w):
        x = np.empty((1, 32, mh * mw, c), np.uint8)
        d = c // heads
        # models/temporal.py:410-423: inner == channels, h·w ≥ 2048, d ≤ 64
        fused = None
        if mh * mw >= 2048 and d <= 64:
            fused = pallas_motion.try_fused_motion_module(x, {}, heads=heads, cfg=cfg,
                                                          interpret=True)
        plan[name] = (fused or pallas_temporal.try_temporal_attention(
            x, x, x, heads=heads, scale=d**-0.5, auto=True) or "plain")
    return {k: str(v) for k, v in plan.items()}


@pytest.mark.parametrize("h,w,expected", [
    (518, 518, dict(vit="flash_attention", m0="temporal_attention", m1="plain",
                    m2="temporal_attention", m3="motion_module")),
    (518, 924, dict(vit="flash_attention", m0="motion_module", m1="plain",
                    m2="motion_module", m3="motion_module")),
])
def test_dispatch_plan_matches_jax_gates(h, w, expected, monkeypatch):
    assert jax_plan(h, w, monkeypatch) == expected
    assert port_plan(h, w) == expected
