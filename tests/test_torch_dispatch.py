"""Which module takes which kernel on the vits, vitb, vitl and vitg main
paths, at 518×518 and 518×924, in the port and in the JAX package, under
``--attn_impl auto`` and ``pallas`` (vitg also in fp32).

The JAX side runs the JAX package's own gate functions with the kernels
they would launch replaced by tags (and, for the temporal gate and the
output tail, a device check that says TPU), so the expected plan is derived
from the JAX gates themselves.  Pure Python: nothing is computed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_depth_anything_torch.config import get_model_config
from video_depth_anything_torch.ops.flash_attention import flash_gate
from video_depth_anything_torch.ops.motion_module import motion_gate
from video_depth_anything_torch.ops.output_tail import output_tail_gate
from video_depth_anything_torch.ops.temporal_attention import temporal_gate
from video_depth_anything_tpu.config import MotionModuleConfig as JCfg
from video_depth_anything_tpu.config import get_model_config as j_model_config
from video_depth_anything_tpu.models.layers import _s2d_profitable
from video_depth_anything_tpu.ops import (
    pallas_attention,
    pallas_motion,
    pallas_output_stack,
    pallas_temporal,
)
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


class _Tag(str):
    def reshape(self, *shape):
        return self


class _FakeTPU:
    platform = "tpu"


class _Spec:
    """Shape and dtype of an array, for gates that read nothing else."""

    def __init__(self, shape, dtype):
        self.shape, self.ndim, self.dtype = shape, len(shape), np.dtype(dtype)


def _module_shapes(encoder, h, w):
    """(name, h, w, C) of the four motion modules for one frame size."""
    cfg = get_model_config(encoder)
    ph, pw = h // 14, w // 14
    oc, f = cfg.out_channels, cfg.features
    return [("m0", ph, pw, oc[2]), ("m1", (ph + 1) // 2, (pw + 1) // 2, oc[3]),
            ("m2", ph, pw, f), ("m3", 2 * ph, 2 * pw, f)]


def port_plan(encoder, h, w, impl="auto", dtype="bfloat16"):
    """The port's plan for activations of ``dtype`` ("bfloat16" or
    "float32"): only the output tail's gate reads the dtype."""
    cfg = get_model_config(encoder)
    heads = cfg.motion.num_heads
    ph, pw = h // 14, w // 14
    n = ph * pw + 1
    plan = {"vit": "flash_attention" if flash_gate((32, n, cfg.vit.num_heads, 64)) else "plain"}
    for name, mh, mw, c in _module_shapes(encoder, h, w):
        if motion_gate(cfg.motion, c, c, 32, mh, mw):
            plan[name] = "motion_module"
        elif temporal_gate((1, 32, mh * mw, c), heads, auto=impl == "auto"):
            plan[name] = "temporal_attention"
        else:
            plan[name] = "plain"
    tail = (32, 8 * ph, 8 * pw, cfg.features // 2)
    plan["tail"] = ("output_tail" if output_tail_gate(cfg, tail, getattr(torch, dtype), 14 * ph,
                                                      14 * pw) else "plain")
    return plan


def jax_plan(encoder, h, w, monkeypatch, impl="auto", dtype="bfloat16"):
    """The JAX gates' plan; with ``dtype="float32"`` the gates see fp32
    arrays (else byte arrays: they read shapes, and the tail's a bf16
    spec)."""
    monkeypatch.setattr(pallas_attention, "flash_attention_native",
                        lambda *a, **k: _Tag("flash_attention"))
    monkeypatch.setattr(pallas_attention, "spatial_flash_attention",
                        lambda *a, **k: _Tag("flash_attention"))
    monkeypatch.setattr(pallas_temporal, "temporal_attention_window",
                        lambda *a, **k: _Tag("temporal_attention"))
    monkeypatch.setattr(pallas_motion, "fused_motion_module",
                        lambda *a, **k: _Tag("motion_module"))
    monkeypatch.setattr(pallas_output_stack, "fused_output_tail",
                        lambda *a, **k: _Tag("output_tail"))
    monkeypatch.setattr(pallas_output_stack, "_on_tpu", lambda: True)
    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeTPU()])
    mcfg = j_model_config(encoder)
    cfg, heads = JCfg(), JCfg().num_heads
    ph, pw = h // 14, w // 14
    n = ph * pw + 1
    arr = np.float32 if dtype == "float32" else np.uint8
    q = np.empty((32, n, mcfg.vit.num_heads, 64), arr)
    plan = {"vit": pallas_attention.try_spatial_attention(q, q, q, 0.125) or "plain"}
    for name, mh, mw, c in _module_shapes(encoder, h, w):
        x = np.empty((1, 32, mh * mw, c), arr)
        d = c // heads
        # models/temporal.py:410-423: inner == channels, h·w ≥ 2048, d ≤ 64
        fused = None
        if mh * mw >= 2048 and d <= 64:
            fused = pallas_motion.try_fused_motion_module(x, {}, heads=heads, cfg=cfg,
                                                          interpret=True)
        plan[name] = (fused or pallas_temporal.try_temporal_attention(
            x, x, x, heads=heads, scale=d**-0.5, auto=impl == "auto") or "plain")
    # models/dpt.py:172-233: no packed output stack, then the kernel's gate
    f = mcfg.features
    tail = None
    if not (_s2d_profitable(f, f // 2) or _s2d_profitable(f // 2, 32)):
        x = _Spec((32, 8 * ph, 8 * pw, f // 2), getattr(jnp, dtype))
        k1, k2 = np.empty((3, 3, f // 2, 32), np.float32), np.empty((1, 1, 32, 1), np.float32)
        tail = pallas_output_stack.try_fused_output_tail(x, k1, None, k2, None, 14 * ph, 14 * pw)
    plan["tail"] = tail or "plain"
    return {k: str(v) for k, v in plan.items()}


@pytest.mark.parametrize("encoder,h,w,expected", [
    ("vits", 518, 518, dict(vit="flash_attention", m0="temporal_attention", m1="plain",
                            m2="temporal_attention", m3="motion_module", tail="plain")),
    ("vits", 518, 924, dict(vit="flash_attention", m0="motion_module", m1="plain",
                            m2="motion_module", m3="motion_module", tail="plain")),
    ("vitl", 518, 518, dict(vit="flash_attention", m0="plain", m1="plain", m2="plain",
                            m3="motion_module", tail="output_tail")),
    ("vitl", 518, 924, dict(vit="flash_attention", m0="plain", m1="plain",
                            m2="motion_module", m3="motion_module", tail="plain")),
    ("vitb", 518, 518, dict(vit="flash_attention", m0="plain", m1="plain",
                            m2="temporal_attention", m3="motion_module", tail="plain")),
    ("vitb", 518, 924, dict(vit="flash_attention", m0="motion_module", m1="plain",
                            m2="motion_module", m3="motion_module", tail="plain")),
], ids=["518-518-expected0", "518-924-expected1", "vitl-518-518", "vitl-518-924",
        "vitb-518-518", "vitb-518-924"])
def test_dispatch_plan_matches_jax_gates(encoder, h, w, expected, monkeypatch):
    assert jax_plan(encoder, h, w, monkeypatch) == expected
    assert port_plan(encoder, h, w) == expected


# Under --attn_impl pallas Kernel B also takes d = 32, 48 and 128 (JAX
# models/temporal.py:131-134, auto=False); the fused module's gate and the
# spatial attention's are those of auto.
@pytest.mark.parametrize("encoder,h,w,expected", [
    ("vits", 518, 518, dict(vit="flash_attention", m0="temporal_attention",
                            m1="temporal_attention", m2="temporal_attention",
                            m3="motion_module", tail="plain")),
    ("vits", 518, 924, dict(vit="flash_attention", m0="motion_module", m1="temporal_attention",
                            m2="motion_module", m3="motion_module", tail="plain")),
    ("vitb", 518, 518, dict(vit="flash_attention", m0="temporal_attention", m1="plain",
                            m2="temporal_attention", m3="motion_module", tail="plain")),
    ("vitb", 518, 924, dict(vit="flash_attention", m0="motion_module", m1="plain",
                            m2="motion_module", m3="motion_module", tail="plain")),
    ("vitl", 518, 518, dict(vit="flash_attention", m0="temporal_attention",
                            m1="temporal_attention", m2="temporal_attention",
                            m3="motion_module", tail="output_tail")),
    ("vitl", 518, 924, dict(vit="flash_attention", m0="temporal_attention",
                            m1="temporal_attention", m2="motion_module", m3="motion_module",
                            tail="plain")),
], ids=["vits-518-518", "vits-518-924", "vitb-518-518", "vitb-518-924", "vitl-518-518",
        "vitl-518-924"])
def test_dispatch_plan_under_pallas_matches_jax_gates(encoder, h, w, expected, monkeypatch):
    assert jax_plan(encoder, h, w, monkeypatch, "pallas") == expected
    assert port_plan(encoder, h, w, "pallas") == expected


# vitg (24 heads of 64, features 384, out_channels 1536): Kernel A at D = 64;
# m0 and m1 (C = 1536, d = 192) plain under both impls; m2 (C = 384, d = 48)
# the einsum under auto at 37² < 2048 locations, Kernel B under pallas,
# Kernel C at 37×66; m3 Kernel C; the tail refused (C = 192).  The gates read
# the dtype only in the tail's, so fp32 plans are bf16's.
_VITG = dict(vit="flash_attention", m0="plain", m1="plain", m3="motion_module", tail="plain")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("h,w,impl,m2", [
    (518, 518, "auto", "plain"), (518, 518, "pallas", "temporal_attention"),
    (518, 924, "auto", "motion_module"), (518, 924, "pallas", "motion_module")])
def test_vitg_dispatch_plan_matches_jax_gates(h, w, impl, m2, dtype, monkeypatch):
    expected = dict(_VITG, m2=m2)
    assert jax_plan("vitg", h, w, monkeypatch, impl, dtype) == expected
    assert port_plan("vitg", h, w, impl, dtype) == expected


def _forced_plan(encoder, h, w, mode, impl="auto"):
    """The port's Kernel C decision per motion module under
    ``VDA_FUSED_MOTION=mode`` (``TemporalModule.fused``)."""
    from video_depth_anything_torch.models.temporal import TemporalModule

    cfg = get_model_config(encoder)
    out = {}
    for name, mh, mw, c in _module_shapes(encoder, h, w):
        mod = TemporalModule.__new__(TemporalModule)  # the gate reads these alone
        mod.cfg, mod.inner, mod.use_kernels = cfg.motion, c, impl.partition(":")[0] != "xla"
        out[name] = mod.fused(32, mh, mw, c)
    return out


def _jax_forced_plan(encoder, h, w, mode, impl, monkeypatch):
    """JAX ``models/temporal.py:400-422`` under ``VDA_FUSED_MOTION=mode``:
    ``0`` off; ``1`` past the h·w and d rule and the ``xla`` check; then
    ``try_fused_motion_module``'s own terms."""
    monkeypatch.setattr(pallas_motion, "fused_motion_module", lambda *a, **k: _Tag("fused"))
    cfg, heads = JCfg(), JCfg().num_heads
    out = {}
    for name, mh, mw, c in _module_shapes(encoder, h, w):
        x = np.empty((1, 32, mh * mw, c), np.uint8)
        d = c // heads
        on = mode != "0" and (impl.partition(":")[0] != "xla" or mode == "1")
        if on and mode != "1":
            on = mh * mw >= 2048 and d <= 64
        out[name] = bool(on and pallas_motion.try_fused_motion_module(
            x, {}, heads=heads, cfg=cfg, interpret=True))
    return out


@pytest.mark.parametrize("mode", ["0", "1", "auto"])
@pytest.mark.parametrize("impl", ["auto", "xla"])
@pytest.mark.parametrize("encoder,h,w", [(e, h, w) for e in ("vits", "vitb", "vitl", "vitg")
                                         for h, w in ((518, 518), (518, 924))])
def test_fused_motion_switch_matches_jax(encoder, h, w, impl, mode, monkeypatch):
    """``VDA_FUSED_MOTION``: ``0`` sends no module to Kernel C, ``1`` every
    module the JAX gate's other terms admit (all four on vits, vitb and
    vitl, under ``xla`` too; on vitg m2 and m3 only: the gate's plan term
    refuses C = 1536), anything else the plan of
    ``test_dispatch_plan_matches_jax_gates``."""
    monkeypatch.setenv("VDA_FUSED_MOTION", mode)
    want = _jax_forced_plan(encoder, h, w, mode, impl, monkeypatch)
    assert _forced_plan(encoder, h, w, mode, impl) == want
    if mode == "0":
        assert not any(want.values())
    if mode == "1":
        if encoder == "vitg":
            assert want == dict(m0=False, m1=False, m2=True, m3=True)
        else:
            assert all(want.values())


def test_forced_widths_kernel_c_lacks_raise_naming_the_queue(monkeypatch):
    """``VDA_FUSED_MOTION=1`` reaches C = 768 (vitb m1) and 1024 (vitl m0,
    m1), which Kernel C has no instantiation for: its launch raises, naming
    ROADMAP Queue 2 B5, and never falls back (checked on CPU tensors with
    the stream lookup stubbed: the checks run before any launch).  vitg's
    m0 and m1 (C = 1536) are not reached: the gate refuses them, in JAX
    too (``test_fused_motion_switch_matches_jax``)."""
    from video_depth_anything_torch.config import MotionModuleConfig
    from video_depth_anything_torch.ops import motion_module as mm

    monkeypatch.setattr(mm.cuda_build, "stream_of", lambda t: None)
    monkeypatch.setenv("VDA_FUSED_MOTION", "1")
    reached = {c for e in ("vitb", "vitl", "vitg") for h, w in ((518, 518), (518, 924))
               for (name, _, _, c) in _module_shapes(e, h, w) if _forced_plan(e, h, w, "1")[name]}
    lacking = sorted(reached - set(mm._SUPPORTED_C))
    assert lacking == [768, 1024]
    cfg = MotionModuleConfig()
    for c in lacking:
        x = torch.zeros(1, 32, 2, c, dtype=torch.bfloat16)
        w = {"w": torch.zeros(8, dtype=torch.bfloat16), "pe": torch.zeros(32, c, dtype=torch.bfloat16)}
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 2 B5"):
            mm._launch_args(x, None, None, w, cfg, 8)
