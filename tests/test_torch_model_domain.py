"""The whole model under the two configurations that reach the kernels'
widened domains, against the JAX package's ``VideoDepthAnything`` in fp32
on the CPU, on the same noised weights (vits widths, encoder cut to 4
blocks): (a) ``packed_output_stack=False`` (vits' output tail, C = 32, then
passes the tail's gate; JAX runs its unpacked output stack) and (b) JAX's
KV-cache test motion config, 4 heads and one attention block
(``io/checkpoint.from_jax_params`` carries its single block across; a
strict load holds every key); and (d) an encoder of one 320-wide head
(``embed_dim=320, num_heads=1``, 4 blocks) on 224² frames, whose 257 tokens
pass Kernel A's gate at D = 320 (the wide kernel's domain).  On the CPU
every kernel wrapper runs its plain version."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import configs, jax_param_shapes, noised_params
from video_depth_anything_torch.config import MotionModuleConfig as TMCfg
from video_depth_anything_torch.config import ViTConfig as TViT
from video_depth_anything_torch.ops import attention as t_attention
from video_depth_anything_torch.ops import flash_attention as t_flash
from video_depth_anything_torch.io.checkpoint import from_jax_params
from video_depth_anything_torch.models.vda import VDAModel
from video_depth_anything_torch.ops.output_tail import output_tail_gate
from video_depth_anything_tpu.config import MotionModuleConfig as JMCfg
from video_depth_anything_tpu.config import ViTConfig as JViT
from video_depth_anything_tpu.models.vda import VDAModel as JaxVDA
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = dict(rtol=1e-3, atol=2e-4)  # as tests/test_torch_model.py


def _pair(name: str, attn_impl: str = "auto"):
    jc, tc = configs("vits", depth=4)
    if name == "unpacked":
        jc = dataclasses.replace(jc, packed_output_stack=False)
        tc = dataclasses.replace(tc, packed_output_stack=False)
    elif name == "d320":
        jc = dataclasses.replace(jc, vit=JViT(embed_dim=320, depth=4, num_heads=1))
        tc = dataclasses.replace(tc, vit=TViT(embed_dim=320, depth=4, num_heads=1))
    else:
        jc = dataclasses.replace(jc, motion=JMCfg(num_heads=4, num_attention_blocks=1))
        tc = dataclasses.replace(tc, motion=TMCfg(num_heads=4, num_attention_blocks=1))
    jm = JaxVDA(cfg=jc, dtype=jnp.float32, attn_impl=attn_impl)
    jm.params = noised_params(jax_param_shapes(jm.module, jnp.zeros((1, 2, 28, 28, 3))), 3)
    tm = VDAModel(cfg=tc, device="cpu", dtype=torch.float32, attn_impl=attn_impl)
    tm.load_state_dict(from_jax_params(jm.params, jc), strict=True)
    return jm, tm


@pytest.mark.parametrize("name,attn_impl", [("unpacked", "auto"), ("kv_motion", "auto"),
                                            ("kv_motion", "pallas")])
def test_window_matches_jax(name, attn_impl):
    jm, tm = _pair(name, attn_impl)
    x = np.random.RandomState(11).randn(1, 8, 70, 70, 3).astype(np.float32)
    want = np.asarray(jm.infer_window(x))
    got = tm.infer_window(x).numpy()
    assert got.shape == want.shape == x.shape[:4]
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("attn_impl", ["auto", "pallas"])
def test_d320_window_matches_jax(attn_impl, monkeypatch):
    """(d): every block's attention goes through ``FlashAttentionFn`` at D =
    320 (the wide kernel on the card); the window matches JAX's."""
    jm, tm = _pair("d320", attn_impl)
    calls = []
    apply = t_attention.FlashAttentionFn.apply

    def counted(q, k, v, *rest):
        calls.append(tuple(q.shape))
        return apply(q, k, v, *rest)

    monkeypatch.setattr(t_attention.FlashAttentionFn, "apply", counted)
    x = np.random.RandomState(12).randn(1, 4, 224, 224, 3).astype(np.float32)
    want = np.asarray(jm.infer_window(x))
    got = tm.infer_window(x).numpy()
    assert calls == [(4, 257, 1, 320)] * 4
    assert all(t_flash.kernel_takes(c, dt) for c in calls for dt in (torch.bfloat16, torch.float32))
    assert got.shape == want.shape == x.shape[:4]
    np.testing.assert_allclose(got, want, **TOL)


def test_configs_reach_the_domains():
    """(a) sends vits' tail (C = 32) to the tail gate in bf16 at 518²; (b)
    builds one attention block of 4 heads in every motion module."""
    _, tc = configs("vits", depth=4)
    unpacked = dataclasses.replace(tc, packed_output_stack=False)
    assert output_tail_gate(unpacked, (32, 296, 296, 32), torch.bfloat16, 518, 518)
    assert not output_tail_gate(tc, (32, 296, 296, 32), torch.bfloat16, 518, 518)
    _, tm = _pair("kv_motion")
    for mod in tm.module.head.motion_modules:
        blk = mod.temporal_transformer.transformer_blocks[0]
        assert len(blk.attention_blocks) == 1 and mod.cfg.num_heads == 4
