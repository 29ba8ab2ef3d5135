"""The backward of each kernel's autograd Function on the CPU against the
JAX package's custom VJPs on the same seeded inputs, in fp32:
``TemporalAttentionFn`` against ``_attention_bwd_math``,
``FusedMotionModuleFn`` against ``jax.vjp`` of ``motion_module_reference``
and ``OutputTailFn`` against ``jax.vjp`` of ``xla_output_tail``; and
gradients through ``TemporalModule``'s fused path reaching every
parameter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_motion_module import _jax_module, _raw
from tests.test_torch_output_tail import _case as _tail_case
from video_depth_anything_torch.config import MotionModuleConfig as TCfg
from video_depth_anything_torch.models.temporal import TemporalModule as TModule
from video_depth_anything_torch.ops import motion_module as t_motion
from video_depth_anything_torch.ops import output_tail as t_tail
from video_depth_anything_torch.ops import temporal_attention as t_temporal
from video_depth_anything_torch.ops.dispatch import plain_reference
from video_depth_anything_tpu.config import MotionModuleConfig as JCfg
from video_depth_anything_tpu.ops import pallas_output_stack as j_tail
from video_depth_anything_tpu.ops.pallas_motion import motion_module_reference
from video_depth_anything_tpu.ops.pallas_temporal import _attention_bwd_math
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# fp32, the same operations in the same order up to the two frameworks'
# summation order (the port's fp32 bound, docs/PARITY.md:12)
TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("c,t,s", [(64, 8, 10), (192, 32, 5)])  # d = 8 and 24
def test_temporal_attention_fn_backward(c, t, s):
    heads, scale = 8, (c // 8) ** -0.5
    rng = np.random.RandomState(c)
    q, k, v, g = (rng.randn(2, t, s, c).astype(np.float32) for _ in range(4))
    want = _attention_bwd_math(*map(jnp.asarray, (q, k, v, g)), heads=heads, scale=scale)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = t_temporal.TemporalAttentionFn.apply(tq, tk, tv, heads, scale)
    torch.testing.assert_close(out, t_temporal.temporal_attention_plain(tq, tk, tv, heads, scale))
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("c,t,s", [(64, 8, 12), (256, 8, 5)])
def test_fused_motion_module_fn_backward(c, t, s):
    _, params = _jax_module(c, t, 1, s, seed=c + 1)
    raw = {k: np.asarray(v) for k, v in _raw(params).items()}
    rng = np.random.RandomState(c)
    x = rng.randn(2, t, s, c).astype(np.float32)
    g = rng.randn(2, t, s, c).astype(np.float32)
    _, vjp = jax.vjp(lambda xx, pp: motion_module_reference(xx, pp, JCfg(), 8),
                     jnp.asarray(x), {k: jnp.asarray(v) for k, v in raw.items()})
    jdx, jdp = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in raw.items()}
    out = t_motion.FusedMotionModuleFn.apply(tx, TCfg(), 8, None, tuple(tp), *tp.values())
    grads = torch.autograd.grad(out, [tx, *tp.values()], torch.from_numpy(g))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jdx), **TOL)
    for name, got in zip(tp, grads[1:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(jdp[name]), err_msg=name, **TOL)


def test_output_tail_fn_backward():
    shape, out_hw = (2, 8, 12, 128), (14, 21)
    x, w1, b1, w2, b2 = _tail_case(shape, seed=5)
    g = np.random.RandomState(6).randn(*shape[:1], *out_hw, 1).astype(np.float32)
    hwio = lambda w: w.transpose(2, 3, 1, 0)  # noqa: E731
    _, vjp = jax.vjp(lambda *a: j_tail.xla_output_tail(*a, *out_hw),
                     *map(jnp.asarray, (x, hwio(w1), b1, hwio(w2), b2)))
    want = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    want[1], want[3] = want[1].transpose(3, 2, 0, 1), want[3].transpose(3, 2, 0, 1)
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, w1, b1, w2, b2)]
    out = t_tail.OutputTailFn.apply(*ins, *out_hw)
    got = torch.autograd.grad(out, ins, torch.from_numpy(g))
    for name, a, b in zip(("x", "w1", "b1", "w2", "b2"), got, want):
        np.testing.assert_allclose(a.numpy(), b, err_msg=name, **TOL)


def test_temporal_module_fused_path_gradients_reach_every_parameter():
    """At h·w ≥ 2048 the module goes through FusedMotionModuleFn; its
    parameter gradients (through ``raw_params``) equal those of the
    unfused plain path, and none is missing."""
    c, t = 64, 8
    torch.manual_seed(0)
    mod = TModule(TCfg(), c)
    with torch.no_grad():
        for p in mod.parameters():
            p.add_(torch.randn_like(p) * 0.1)
    x = torch.randn(1, t, 46, 46, c)
    assert t_motion.motion_gate(TCfg(), c, c, t, 46, 46)
    g = torch.randn_like(x)

    def grads():
        mod.zero_grad(set_to_none=True)
        mod(x).backward(g)
        return {n: p.grad.clone() for n, p in mod.named_parameters()}

    fused = grads()
    with plain_reference():
        plain = grads()
    assert fused.keys() == plain.keys() == dict(mod.named_parameters()).keys()
    for name in plain:
        assert float(fused[name].abs().max()) > 0, name
        # fp32 sums over 8·46² locations in another order: 1e-5 of the
        # largest entry (measured: under 1e-6)
        scale = float(plain[name].abs().max())
        torch.testing.assert_close(fused[name], plain[name], rtol=1e-4, atol=1e-5 * scale,
                                   msg=name)


@pytest.mark.parametrize("launch", ["temporal_attention", "fused_motion_module", "output_tail"])
def test_raw_launches_refuse_to_drop_gradients(launch):
    x = torch.zeros(1, 8, 4, 64, requires_grad=True)
    with pytest.raises(RuntimeError, match="autograd"):
        if launch == "temporal_attention":
            t_temporal.temporal_attention(x, x, x, 8, 0.3)
        elif launch == "fused_motion_module":
            t_motion.fused_motion_module(x, {"w_in": x}, TCfg(), 8)
        else:
            t_tail.output_tail(x, x, x, x, x, 4, 4)
