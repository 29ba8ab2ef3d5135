"""Which module takes which kernel on the vits, vitb, vitl and vitg main
paths, at 518×518 and 518×924, in the port and in the JAX package, under
``--attn_impl auto`` and ``pallas`` (vitg and d320, 4 heads of 320 with
vitl's head, also in fp32).

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
    cfg = get_model_config(encoder)  # the widths alone: no config field moves them
    ph, pw = h // 14, w // 14
    oc, f = cfg.out_channels, cfg.features
    return [("m0", ph, pw, oc[2]), ("m1", (ph + 1) // 2, (pw + 1) // 2, oc[3]),
            ("m2", ph, pw, f), ("m3", 2 * ph, 2 * pw, f)]


def port_plan(encoder, h, w, impl="auto", dtype="bfloat16", cfg=None):
    """The port's plan for activations of ``dtype`` ("bfloat16" or
    "float32"): only the output tail's gate reads the dtype.  ``cfg``: a
    ``ModelConfig`` of the encoder other than the shipped one."""
    cfg = cfg or get_model_config(encoder)
    heads = cfg.motion.num_heads
    ph, pw = h // 14, w // 14
    n = ph * pw + 1
    d = cfg.vit.embed_dim // cfg.vit.num_heads
    plan = {"vit": "flash_attention" if flash_gate((32, n, cfg.vit.num_heads, d)) else "plain"}
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


def jax_plan(encoder, h, w, monkeypatch, impl="auto", dtype="bfloat16", mcfg=None):
    """The JAX gates' plan; with ``dtype="float32"`` the gates see fp32
    arrays (else byte arrays: they read shapes, and the tail's a bf16
    spec).  ``mcfg``: a JAX ``ModelConfig`` of the encoder other than the
    shipped one."""
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
    mcfg = mcfg or j_model_config(encoder)
    cfg, heads = mcfg.motion, mcfg.motion.num_heads
    ph, pw = h // 14, w // 14
    n = ph * pw + 1
    arr = np.float32 if dtype == "float32" else np.uint8
    q = np.empty((32, n, mcfg.vit.num_heads, mcfg.vit.embed_dim // mcfg.vit.num_heads), arr)
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
    packed = mcfg.packed_output_stack and (_s2d_profitable(f, f // 2)
                                           or _s2d_profitable(f // 2, 32))
    if mcfg.fused_output_tail and not packed:
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


def _forced_plan(encoder, h, w, mode, impl="auto", cfg=None):
    """The port's Kernel C decision per motion module under
    ``VDA_FUSED_MOTION=mode`` (``TemporalModule.fused``)."""
    from video_depth_anything_torch.models.temporal import TemporalModule

    cfg = cfg or get_model_config(encoder)
    out = {}
    for name, mh, mw, c in _module_shapes(encoder, h, w):
        mod = TemporalModule.__new__(TemporalModule)  # the gate reads these alone
        mod.cfg, mod.inner, mod.use_kernels = cfg.motion, c, impl.partition(":")[0] != "xla"
        out[name] = mod.fused(32, mh, mw, c)
    return out


def _jax_forced_plan(encoder, h, w, mode, impl, monkeypatch, cfg=None):
    """JAX ``models/temporal.py:400-422`` under ``VDA_FUSED_MOTION=mode``:
    ``0`` off; ``1`` past the h·w and d rule and the ``xla`` check; then
    ``try_fused_motion_module``'s own terms (``cfg``: a JAX
    ``MotionModuleConfig`` other than the shipped one)."""
    monkeypatch.setattr(pallas_motion, "fused_motion_module", lambda *a, **k: _Tag("fused"))
    cfg = cfg or JCfg()
    heads = cfg.num_heads
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_forced_widths_take_the_wide_kernel_c(dtype, monkeypatch):
    """``VDA_FUSED_MOTION=1`` reaches C = 768 (vitb m1) and 1024 (vitl m0,
    m1): Kernel C takes both in bf16 and in fp32 (``_launch_args`` accepts
    their ``kernel_weights``; checked on CPU tensors with the stream lookup
    stubbed: the checks run before any launch), and still refuses a shape
    outside its domain (T = 40 frames) without naming a queue.  vitg's m0
    and m1 (C = 1536) are not reached: the gate refuses them, in JAX too
    (``test_fused_motion_switch_matches_jax``)."""
    from video_depth_anything_torch.config import MotionModuleConfig
    from video_depth_anything_torch.ops import motion_module as mm

    monkeypatch.setattr(mm.cuda_build, "stream_of", lambda t: None)
    monkeypatch.setenv("VDA_FUSED_MOTION", "1")
    reached = {c for e in ("vitb", "vitl", "vitg") for h, w in ((518, 518), (518, 924))
               for (name, _, _, c) in _module_shapes(e, h, w) if _forced_plan(e, h, w, "1")[name]}
    cfg = MotionModuleConfig()
    assert {768, 1024} <= reached
    assert all(mm.kernel_takes((1, 32, 2, c), cfg, 8, dtype) for c in reached)

    def zeros(c):
        shapes = dict(gn_scale=(c,), gn_bias=(c,), w_in=(c, c), b_in=(c,), ln_scale=(3, c),
                      ln_bias=(3, c), wq=(2, c, c), wk=(2, c, c), wv=(2, c, c), wo=(2, c, c),
                      bo=(2, c), w1=(c, 8 * c), b1=(8 * c,), w2=(4 * c, c), b2=(c,),
                      w_out=(c, c), b_out=(c,))
        return {k: torch.zeros(v) for k, v in shapes.items()}

    for c in (768, 1024):
        x = torch.zeros(1, 32, 2, c, dtype=dtype)
        w = mm.kernel_weights(zeros(c), cfg, dtype)
        gna = gnb = torch.zeros(1, 32, c)
        out, _, args = mm._launch_args(x, gna, gnb, w, cfg, 8)
        assert out.shape == x.shape and out.dtype == dtype and args[-5:-3] == (2, c)
    x = torch.zeros(1, 40, 2, 512, dtype=dtype)
    w = {"w": torch.zeros(8, dtype=dtype), "pe": torch.zeros(40, 512, dtype=dtype)}
    with pytest.raises(NotImplementedError, match="8 <= T <= 32") as err:
        mm._launch_args(x, None, None, w, cfg, 8)
    assert "Queue" not in str(err.value) and "B5" not in str(err.value)


# The configurations the port's kernel domains were widened for.  (a) vits and
# vitb under packed_output_stack=False (JAX tests/test_s2d_conv.py builds it):
# their tails, C = 32 and 64, take the tail kernel at 518x518 (518x924 is
# beyond the gate's VMEM term); every module keeps the shipped plan.  (b) vits
# with JAX's KV-cache test motion config (4 heads, one attention block):
# under auto, m2 (C = 64, d = 16) takes Kernel B and m3 Kernel C at 4 heads;
# under pallas, m0 (d = 48) and m1 (d = 96, the run-time-d kernel) take
# Kernel B too; under VDA_FUSED_MOTION=1 Kernel C takes all four modules.
def _domain_configs(name, encoder):
    import dataclasses

    from video_depth_anything_torch.config import MotionModuleConfig as TMCfg

    jc, tc = j_model_config(encoder), get_model_config(encoder)
    if name == "unpacked":
        return (dataclasses.replace(jc, packed_output_stack=False),
                dataclasses.replace(tc, packed_output_stack=False))
    return (dataclasses.replace(jc, motion=JCfg(num_heads=4, num_attention_blocks=1)),
            dataclasses.replace(tc, motion=TMCfg(num_heads=4, num_attention_blocks=1)))


DOMAIN_PLANS = {
    ("unpacked", "vits", 518, 924, "auto"): dict(
        vit="flash_attention", m0="motion_module", m1="plain", m2="motion_module",
        m3="motion_module", tail="plain"),
    ("unpacked", "vits", 518, 518, "auto"): dict(
        vit="flash_attention", m0="temporal_attention", m1="plain", m2="temporal_attention",
        m3="motion_module", tail="output_tail"),
    ("unpacked", "vitb", 518, 518, "auto"): dict(
        vit="flash_attention", m0="plain", m1="plain", m2="temporal_attention",
        m3="motion_module", tail="output_tail"),
    ("kv_motion", "vits", 518, 518, "auto"): dict(
        vit="flash_attention", m0="plain", m1="plain", m2="temporal_attention",
        m3="motion_module", tail="plain"),
    ("kv_motion", "vits", 518, 518, "pallas"): dict(
        vit="flash_attention", m0="temporal_attention", m1="temporal_attention",
        m2="temporal_attention", m3="motion_module", tail="plain"),
}


@pytest.mark.parametrize("name,encoder,h,w,impl", list(DOMAIN_PLANS))
def test_domain_config_plans_match_jax_gates(name, encoder, h, w, impl, monkeypatch):
    jc, tc = _domain_configs(name, encoder)
    expected = DOMAIN_PLANS[(name, encoder, h, w, impl)]
    assert jax_plan(encoder, h, w, monkeypatch, impl, mcfg=jc) == expected
    assert port_plan(encoder, h, w, impl, cfg=tc) == expected


def test_kv_motion_config_forced_plan_matches_jax(monkeypatch):
    """(b) under ``VDA_FUSED_MOTION=1``: Kernel C at 4 heads and one block
    on all four modules (C = 192, 384, 64, 64), in the port as in JAX; the
    port's Kernel C and Kernel B take each module the plans send them."""
    from video_depth_anything_torch.ops import motion_module as mm
    from video_depth_anything_torch.ops import temporal_attention as ta

    jc, tc = _domain_configs("kv_motion", "vits")
    monkeypatch.setenv("VDA_FUSED_MOTION", "1")
    want = _jax_forced_plan("vits", 518, 518, "1", "auto", monkeypatch, cfg=jc.motion)
    assert _forced_plan("vits", 518, 518, "1", cfg=tc) == want == dict(m0=True, m1=True, m2=True,
                                                                      m3=True)
    for _, mh, mw, c in _module_shapes("vits", 518, 518):
        for dtype in (torch.bfloat16, torch.float32):
            assert mm.kernel_takes((1, 32, mh * mw, c), tc.motion, 4, dtype)
            assert not mm.resident(c, 4, tc.motion)
            assert ta.kernel_takes((1, 32, mh * mw, c), 4, dtype)
    assert [ta.instantiated(c, 4) for _, _, _, c in _module_shapes("vits", 518, 518)] == \
        [True, False, True, True]


def _plan_launches(encoder, cfg, impl, mode, monkeypatch, h=518, w=518):
    """Exact launches of one ``h`` x ``w`` window call of ``cfg`` from the
    port's plan: Kernel A a ViT block (on the wide kernel past D = 192);
    Kernel B once an attention block, on the instantiated or the run-time-d
    kernel, by head width; Kernel C once a module, resident or wide; the
    tail once, by C."""
    from video_depth_anything_torch.ops import flash_attention as fa
    from video_depth_anything_torch.ops import motion_module as mm
    from video_depth_anything_torch.ops import temporal_attention as ta

    monkeypatch.setenv("VDA_FUSED_MOTION", mode)
    plan = port_plan(encoder, h, w, impl, cfg=cfg)
    forced = _forced_plan(encoder, h, w, mode, impl, cfg=cfg)
    wide = fa.wide(cfg.vit.embed_dim // cfg.vit.num_heads)
    counts, widths, tails = {}, {}, {}
    if plan["vit"] == "flash_attention":
        counts["flash_attention_wide" if wide else "flash_attention"] = cfg.vit.depth
    heads, blocks = cfg.motion.num_heads, cfg.motion.num_attention_blocks
    for name, _, _, c in _module_shapes(encoder, h, w):
        if forced[name]:
            key = "fused_motion_module" if mm.resident(c, heads, cfg.motion) else \
                "fused_motion_module_wide"
            counts[key] = counts.get(key, 0) + 1
        elif plan[name] == "temporal_attention":
            key = "temporal_attention" if ta.instantiated(c, heads) else "temporal_attention_any"
            counts[key] = counts.get(key, 0) + blocks
            widths[c // heads] = widths.get(c // heads, 0) + blocks
    if plan["tail"] == "output_tail":
        counts["output_tail"] = 1
        tails[cfg.features // 2] = 1
    return counts, widths, tails


def test_chip_smoke_domain_windows_follow_the_plans(monkeypatch):
    """chip_smoke.py phase domain's exact launches of (a) and (b) are the
    port's plans (held to JAX's above), counted launch by launch."""
    import chip_smoke

    for name, encoder, impl, mode, plan, widths, tails in chip_smoke.DOMAIN_WINDOWS:
        cfg = chip_smoke.domain_model_config(name, encoder)
        assert _plan_launches(encoder, cfg, impl, mode, monkeypatch) == (plan, widths, tails)


def test_chip_smoke_domain_sweeps_cover_the_gates():
    """Phase domain's op-level sweeps: every width the gates admit at
    DOMAIN_B_HEADS (Kernel B, pallas) and at 8 heads, two blocks and
    ff_mult 4 (Kernel C, forced), and each is a shape the kernels take."""
    import chip_smoke
    from video_depth_anything_torch.config import MotionModuleConfig as TMCfg
    from video_depth_anything_torch.ops import motion_module as mm
    from video_depth_anything_torch.ops import temporal_attention as ta

    b = chip_smoke.domain_b_shapes()
    assert {h for _, h in b} == set(chip_smoke.DOMAIN_B_HEADS) and (2048, 16) in b
    assert all(ta.kernel_takes((1, 32, 1, c), h, dt) for c, h in b
               for dt in (torch.bfloat16, torch.float32))
    c_rows = chip_smoke.domain_c_shapes()
    assert [c for c, h, nb, ff in c_rows if (h, nb, ff) == (8, 2, 4)][-1] == 1280
    for c, h, nb, ff in c_rows:
        cfg = TMCfg(num_heads=h, num_attention_blocks=nb, ff_mult=ff)
        assert mm.kernel_takes((1, 32, 1, c), cfg, h, torch.bfloat16)
    assert {(h, nb, ff) for _, h, nb, ff in c_rows} == {(8, 2, 4), *chip_smoke.DOMAIN_C_CFGS}


# d320 (chip_smoke.py phase wide): ViT-H/14's width in 4 heads of 320, 24
# blocks, vitl's head and motion modules.  Kernel A's gate admits D = 320
# (the wide kernel); every module and the tail take vitl's plan, under
# both impls and (the gates read the dtype only in the tail's) in fp32.
_D320 = {
    (518, 518, "auto"): dict(vit="flash_attention", m0="plain", m1="plain", m2="plain",
                             m3="motion_module", tail="output_tail"),
    (518, 518, "pallas"): dict(vit="flash_attention", m0="temporal_attention",
                               m1="temporal_attention", m2="temporal_attention",
                               m3="motion_module", tail="output_tail"),
    (518, 924, "auto"): dict(vit="flash_attention", m0="plain", m1="plain",
                             m2="motion_module", m3="motion_module", tail="plain"),
    (518, 924, "pallas"): dict(vit="flash_attention", m0="temporal_attention",
                               m1="temporal_attention", m2="motion_module", m3="motion_module",
                               tail="plain"),
}


def _d320_configs():
    import dataclasses

    import chip_smoke
    from video_depth_anything_tpu.config import ViTConfig as JViT

    tc = chip_smoke.d320_config()
    jc = dataclasses.replace(j_model_config("vitl"), vit=JViT(**chip_smoke.D320_VIT),
                             intermediate_layer_idx=tc.intermediate_layer_idx)
    return jc, tc


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("h,w,impl", list(_D320))
def test_d320_dispatch_plan_matches_jax_gates(h, w, impl, dtype, monkeypatch):
    jc, tc = _d320_configs()
    expected = dict(_D320[(h, w, impl)])
    if dtype == "float32":  # the tail kernel is bf16 only, in JAX as in the port
        expected["tail"] = "plain"
    assert jax_plan("vitl", h, w, monkeypatch, impl, dtype, mcfg=jc) == expected
    assert port_plan("vitl", h, w, impl, dtype, cfg=tc) == expected
    assert tc.vit.embed_dim // tc.vit.num_heads == 320 and tc.vit.depth == 24


def test_chip_smoke_wide_windows_follow_the_plans(monkeypatch):
    """chip_smoke.py phase wide's exact launches (WIDE_WINDOWS; ``auto:fast``
    takes ``auto``'s plan) and its fp32 plan are the port's plans, held to
    JAX's above, counted launch by launch; d320 is vitl with the encoder
    swapped, and its head's shapes are vitl's."""
    import chip_smoke

    _, tc = _d320_configs()
    for (h, w, impl), (plan, widths) in chip_smoke.WIDE_WINDOWS.items():
        counts, got_widths, tails = _plan_launches("vitl", tc, impl.split(":")[0], "auto",
                                                   monkeypatch, h, w)
        assert (counts, got_widths) == (plan, widths), (h, w, impl)
        assert tails == ({128: 1} if plan.get("output_tail") else {})
    f32 = port_plan("vitl", 518, 518, "auto", "float32", cfg=tc)
    want = {"flash_attention_wide_f32": 24,
            "fused_motion_module_f32": sum(f32[m] == "motion_module" for m in ("m0", "m1", "m2",
                                                                                 "m3"))}
    assert f32["tail"] == "plain" and set(f32.values()) <= {"flash_attention", "motion_module",
                                                             "plain"}
    assert chip_smoke.WIDE_F32_PLAN == want
    vitl = get_model_config("vitl")
    assert (tc.features, tc.out_channels, tc.motion) == (vitl.features, vitl.out_channels,
                                                         vitl.motion)
