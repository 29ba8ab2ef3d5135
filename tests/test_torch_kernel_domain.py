"""The domains of Kernels A, B and C and the output tail against the JAX
gates that send work to them: every shape a JAX gate admits, the port's
kernel takes (``kernel_takes`` of ``ops/flash_attention``,
``ops/temporal_attention``, ``ops/motion_module`` and ``ops/output_tail``:
pure predicates, the same checks that the launch paths raise on).

The JAX gates are asked as ``tests/test_torch_dispatch.py`` asks them: the
JAX package's own gate functions with the kernels they would launch
replaced by tags and a device check that says TPU.  The enumeration: C a
multiple of 8 up to 2048; heads 1, 2, 4, 8 and 16; 1, 2 or 3 attention
blocks and ff_mult 2 or 4 (Kernel C); T = 8, 16, 24 and 32; bf16 and fp32;
Kernel B under ``auto`` and ``pallas``, Kernel C under its size rule and
forced past it (``VDA_FUSED_MOTION=1``) at 74² locations.  The tail at C =
32, 64 and 128 under both values of ``packed_output_stack`` and
``fused_output_tail``, at the map sizes of 518², 518×924, 280×924 and 70²
frames.  Kernel B also at every C below 32.  Kernel A: D a multiple of 64 up to 2048, heads 1-16, N from 256
(ragged and whole 64- and 128-key tiles, past JAX's 2048-key whole row),
B·T 1 and 32, both dtypes.  Pure Python: nothing is computed."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_depth_anything_torch.config import MotionModuleConfig as TCfg
from video_depth_anything_torch.config import get_model_config
from video_depth_anything_torch.ops import flash_attention as t_flash
from video_depth_anything_torch.ops import motion_module as t_motion
from video_depth_anything_torch.ops import output_tail as t_tail
from video_depth_anything_torch.ops import temporal_attention as t_temporal
from video_depth_anything_tpu.config import MotionModuleConfig as JCfg
from video_depth_anything_tpu.config import get_model_config as j_model_config
from video_depth_anything_tpu.models.dpt import DPTHeadTemporal
from video_depth_anything_tpu.ops import flash_attention as j_flash
from video_depth_anything_tpu.ops import (
    pallas_attention,
    pallas_motion,
    pallas_output_stack,
    pallas_temporal,
)
from tests.test_torch_dispatch import _FakeTPU, _Spec, _Tag
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

WIDTHS = range(8, 2049, 8)
HEADS = (1, 2, 4, 8, 16)
FRAMES = (8, 16, 24, 32)
DTYPES = ((np.float32, torch.float32), (jnp.bfloat16, torch.bfloat16))
LOCATIONS = 74 * 74


@pytest.fixture
def tagged(monkeypatch):
    """The JAX gates with their kernels replaced by tags, on a 'TPU'."""
    monkeypatch.setattr(pallas_temporal, "temporal_attention_window",
                        lambda *a, **k: _Tag("temporal_attention"))
    monkeypatch.setattr(pallas_motion, "fused_motion_module", lambda *a, **k: _Tag("motion"))
    monkeypatch.setattr(pallas_output_stack, "fused_output_tail", lambda *a, **k: _Tag("tail"))
    monkeypatch.setattr(pallas_output_stack, "_on_tpu", lambda: True)
    monkeypatch.setattr(j_flash, "_on_tpu", lambda: True)
    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeTPU()])


class _View(_Spec):
    """A ``_Spec`` that the gate may reshape (the native layout's merge)."""

    def reshape(self, *shape):
        return _View(shape, self.dtype)


@pytest.mark.parametrize("heads", range(1, 17))
def test_kernel_a_takes_every_shape_the_jax_gate_admits(heads, monkeypatch):
    """``try_spatial_attention`` with its two kernels replaced by tags: every
    (B·T, N, H, D) it sends to either is one ``flash_gate`` admits and
    ``kernel_takes`` takes in bf16 and fp32; every shape it refuses,
    ``flash_gate`` refuses."""
    monkeypatch.setattr(pallas_attention, "flash_attention_native", lambda *a, **k: _Tag("a"))
    monkeypatch.setattr(pallas_attention, "spatial_flash_attention", lambda *a, **k: _Tag("a"))
    admitted = 0
    for d in range(64, 2049, 64):
        for n in (255, 256, 300, 1370, 2048, 2443, 4097):
            for bt in (1, 32):
                x = _View((bt, n, heads, d), jnp.bfloat16)
                jax_says = pallas_attention.try_spatial_attention(x, x, x, 1.0) is not None
                assert t_flash.flash_gate(x.shape) == jax_says, (bt, n, heads, d)
                if jax_says:
                    admitted += 1
                    for _, tdt in DTYPES:
                        assert t_flash.kernel_takes(x.shape, tdt), (bt, n, heads, d, tdt)
    assert admitted == 2 * 6 * 16  # D = 64, 192, 320, ..., 1984 at six N, two batches


def test_kernel_a_routes_past_d192_to_the_wide_kernel():
    """D = 64 and 192 keep the Hopper kernels, every other admitted width
    takes the wide kernel; widths the gate refuses, and fp16, are refused."""
    assert [d for d in range(64, 2049, 64) if t_flash.wide(d)] == list(range(320, 2049, 128))
    assert not any(t_flash.wide(d) for d in t_flash.HEAD_DIMS)
    for d in (128, 256, 96):
        assert not t_flash.kernel_takes((1, 300, 2, d), torch.bfloat16)
    assert not t_flash.kernel_takes((1, 300, 2, 320), torch.float16)
    assert not t_flash.kernel_takes((300, 2, 320), torch.bfloat16)


@pytest.mark.parametrize("heads", HEADS)
def test_kernel_b_takes_every_shape_the_jax_gate_admits(heads, tagged):
    """C a multiple of 8 up to 2048 and every C below 32, so that the
    widths the gate admits that are not multiples of 8 (C = 1-7, 10, 12,
    14, 20, 28 at one head, ...) are held to ``kernel_takes`` in both
    dtypes too."""
    admitted = 0
    for c in sorted(set(range(1, 32)) | set(WIDTHS)):
        for t in FRAMES:
            for jdt, tdt in DTYPES:
                x = _Spec((1, t, LOCATIONS, c), jdt)
                for auto in (True, False):
                    if pallas_temporal.try_temporal_attention(
                            x, x, x, heads=heads, scale=1.0, auto=auto) is None:
                        continue
                    admitted += 1
                    assert t_temporal.temporal_gate(x.shape, heads, auto=auto)
                    assert t_temporal.kernel_takes(x.shape, heads, tdt), (c, heads, t, tdt, auto)
    assert admitted > 0


def test_kernel_b_routes_the_shipped_widths_to_the_instantiated_kernels():
    """d in {8, 16, 24, 32, 48, 128} at C ≤ 1024 keep the instantiated
    kernels; the other admitted widths take the run-time-d kernel; a
    shape the kernels cannot hold (T = 33) is refused."""
    for c, heads in ((64, 8), (192, 8), (384, 8), (1024, 8), (256, 8), (128, 16), (192, 4)):
        assert t_temporal.instantiated(c, heads)
    for c, heads in ((40, 8), (512, 8), (2048, 16), (1024, 16), (384, 4), (512, 1), (12, 4)):
        assert not t_temporal.instantiated(c, heads)
        assert t_temporal.kernel_takes((1, 32, 9, c), heads, torch.float32)
    assert not t_temporal.kernel_takes((1, 33, 9, 64), 8, torch.bfloat16)
    assert not t_temporal.kernel_takes((1, 32, 9, 64), 8, torch.float16)


@pytest.mark.parametrize("ff", (2, 4))
@pytest.mark.parametrize("blocks", (1, 2, 3))
@pytest.mark.parametrize("heads", HEADS)
def test_kernel_c_takes_every_shape_the_jax_gate_admits(heads, blocks, ff, tagged):
    """Forced (the gate's own terms) and under the size rule (h·w ≥ 2048,
    d ≤ 64: JAX ``models/temporal.py:410-418``), whose shapes are a
    subset."""
    jcfg = JCfg(num_heads=heads, num_attention_blocks=blocks, ff_mult=ff)
    tcfg = TCfg(num_heads=heads, num_attention_blocks=blocks, ff_mult=ff)
    admitted = 0
    for c in WIDTHS:
        for t in FRAMES:
            for jdt, tdt in DTYPES:
                x = _Spec((1, t, LOCATIONS, c), jdt)
                if pallas_motion.try_fused_motion_module(x, {}, heads=heads, cfg=jcfg,
                                                         interpret=True) is None:
                    assert not t_motion.motion_gate(tcfg, c, c, t, 74, 74, force=True)
                    continue
                admitted += 1
                assert t_motion.motion_gate(tcfg, c, c, t, 74, 74, force=True)
                if c // heads <= 64:  # the size rule admits it too
                    assert t_motion.motion_gate(tcfg, c, c, t, 74, 74)
                assert t_motion.kernel_takes(x.shape, tcfg, heads, tdt), (c, t, tdt)
    assert admitted > 0


def test_kernel_c_routes_off_the_resident_domain_to_the_wide_chain():
    """The resident kernels keep their seven widths at 8 heads, two blocks
    and ff_mult 4; every other config takes the wide chain."""
    cfg = TCfg()
    assert all(t_motion.resident(c, 8, cfg) for c in t_motion.RESIDENT_C)
    assert not any(t_motion.resident(c, 8, cfg) for c in (8, 96, 512, 768, 1024))
    for other in (TCfg(num_heads=4), TCfg(num_attention_blocks=1), TCfg(ff_mult=2)):
        assert not t_motion.resident(64, other.num_heads, other)
    assert not t_motion.kernel_takes((1, 7, 9, 64), cfg, 8, torch.bfloat16)
    assert not t_motion.kernel_takes((1, 8, 9, 64), TCfg(num_transformer_blocks=2), 8,
                                     torch.bfloat16)


class _Head:
    """The JAX head's tail gate (``_head_kernels_ok``, ``_packed_plan``) on
    a config alone."""

    _packed_plan = DPTHeadTemporal._packed_plan
    _head_kernels_ok = DPTHeadTemporal._head_kernels_ok

    def __init__(self, cfg):
        self.cfg = cfg

    def is_initializing(self):
        return False


# (N, H, W, out_h, out_w): output_conv1's maps of 518², 518×924 (refused by
# the VMEM term), 280×924 and 70² windows of 32 frames, and 518² at the
# window batch of 4
TAIL_MAPS = ((32, 296, 296, 518, 518), (128, 296, 296, 518, 518), (32, 296, 528, 518, 924),
             (32, 160, 528, 280, 924), (32, 40, 40, 70, 70))


@pytest.mark.parametrize("fused", (True, False))
@pytest.mark.parametrize("packed", (True, False))
@pytest.mark.parametrize("encoder", ("vits", "vitb", "vitl"))
def test_tail_takes_every_shape_the_jax_gate_admits(encoder, packed, fused, tagged):
    """vits' C = 32, vitb's 64, vitl's 128: the port's gate decides as JAX's
    head and gate do, and its kernel takes every map they admit (vits and
    vitb only with the packed output stack off)."""
    jcfg = dataclasses.replace(j_model_config(encoder), packed_output_stack=packed,
                               fused_output_tail=fused)
    tcfg = dataclasses.replace(get_model_config(encoder), packed_output_stack=packed,
                               fused_output_tail=fused)
    c = jcfg.features // 2
    k1, k2 = np.empty((3, 3, c, 32), np.float32), np.empty((1, 1, 32, 1), np.float32)
    admitted = 0
    for n, h, w, oh, ow in TAIL_MAPS:
        x = _Spec((n, h, w, c), jnp.bfloat16)
        head = _Head(jcfg)
        jax_says = (head._head_kernels_ok(types.SimpleNamespace(dtype=jnp.bfloat16)) and
                    pallas_output_stack.try_fused_output_tail(x, k1, None, k2, None, oh, ow)
                    is not None)
        assert t_tail.output_tail_gate(tcfg, x.shape, torch.bfloat16, oh, ow) == jax_says
        if jax_says:
            admitted += 1
            assert t_tail.kernel_takes(x.shape, torch.bfloat16, oh, ow)
    assert (admitted > 0) == (fused and (encoder == "vitl" or not packed))
