"""The port's optimizer (``train/trainer.make_optimizer``) against the JAX
package's (optax) over 6 steps of seeded gradients: the parameters after
each step."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from video_depth_anything_torch.train.trainer import make_optimizer as t_make
from video_depth_anything_tpu.train.trainer import make_optimizer as j_make
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# fp32 elementwise updates; Adam divides by sqrt(v), so a last-bit
# difference in the gradient's square moves the step by ~1e-7 relative
TOL = dict(rtol=1e-5, atol=1e-8)

CASES = {
    "plain": dict(learning_rate=1e-2, train_encoder=True),
    "clip_active": dict(learning_rate=1e-2, train_encoder=True, clip_norm=0.05),
    "warmup_cosine": dict(learning_rate=1e-2, train_encoder=True, warmup_steps=2, decay_steps=5),
    "accum_2": dict(learning_rate=1e-2, train_encoder=True, accum_steps=2, warmup_steps=2),
    "frozen_encoder": dict(learning_rate=1e-2, train_encoder=False),
}


@pytest.mark.parametrize("case", CASES)
def test_optimizer_matches_optax(case):
    kw = CASES[case]
    rng = np.random.RandomState(0)
    shapes = {"pretrained": {"w": (4, 5), "b": (5,)}, "head": {"w": (3, 6), "b": (6,)}}
    params = {m: {k: rng.randn(*s).astype(np.float32) for k, s in d.items()}
              for m, d in shapes.items()}
    tx = j_make(**kw)
    jp = {m: {k: jnp.asarray(v) for k, v in d.items()} for m, d in params.items()}
    state = tx.init(jp)
    t_opt = t_make(**kw)
    tp = {f"{m}.{k}": torch.from_numpy(v.copy()) for m, d in params.items() for k, v in d.items()}
    trainable = {n: p for n, p in tp.items() if t_opt.trainable(n)}
    t_state = t_opt.init(trainable)
    for step in range(6):
        grads = {m: {k: (rng.randn(*s) * 0.3).astype(np.float32) for k, s in d.items()}
                 for m, d in shapes.items()}
        updates, state = tx.update(jax_tree(grads), state, jp)
        jp = optax.apply_updates(jp, updates)
        applied = t_opt.update(trainable, {n: torch.from_numpy(grads[n.split(".")[0]][n.split(".")[1]])
                                           for n in trainable}, t_state)
        assert applied == (step % kw.get("accum_steps", 1) == kw.get("accum_steps", 1) - 1)
        for n, p in tp.items():
            m, k = n.split(".")
            np.testing.assert_allclose(p.numpy(), np.asarray(jp[m][k]), err_msg=f"{case} {n} {step}",
                                       **TOL)
    if not kw["train_encoder"]:
        np.testing.assert_array_equal(tp["pretrained.w"].numpy(), params["pretrained"]["w"])


def jax_tree(grads):
    return {m: {k: jnp.asarray(v) for k, v in d.items()} for m, d in grads.items()}


@pytest.mark.parametrize("warmup,decay", [(0, 0), (3, 0), (3, 10), (0, 10)])
def test_schedule_matches_optax(warmup, decay):
    opt = t_make(1e-3, warmup_steps=warmup, decay_steps=decay)
    if warmup or decay:
        sched = optax.warmup_cosine_decay_schedule(0.0, 1e-3, max(1, warmup), decay or 10**9,
                                                   0.0 if decay else 1e-3)
    else:
        sched = lambda c: 1e-3  # noqa: E731
    for count in range(14):
        np.testing.assert_allclose(opt.lr(count), float(sched(count)), rtol=1e-6, atol=1e-12)


def test_update_rebuilds_kernel_c_weights():
    """An optimizer update writes the parameters in place, which bumps
    their versions: TemporalModule rebuilds Kernel C's weights once."""
    from video_depth_anything_torch.config import MotionModuleConfig
    from video_depth_anything_torch.models.temporal import TemporalModule

    mod = TemporalModule(MotionModuleConfig(), 64)
    opt = t_make(1e-2, train_encoder=True)
    params = dict(mod.named_parameters())
    state = opt.init(params)
    first = mod.kernel_weights()
    assert mod.kernel_weights() is first
    opt.update(params, {n: torch.ones_like(p) for n, p in params.items()}, state)
    rebuilt = mod.kernel_weights()
    assert rebuilt is not first and mod.kernel_weights() is rebuilt
    assert not torch.equal(rebuilt["w"], first["w"])
