"""Three ``Trainer.step``s of the port against the JAX package's
``Trainer`` on the same noised weights and batches: vits at full widths,
2 encoder blocks, 28×28, T = 2, fp32 on the CPU, with the recompute (whole
forward and motion modules) on and off; here with the encoder frozen,
``test_torch_trainer_encoder.py`` with it trained.  The JAX side runs
without remat, which changes what its backward keeps, not what it
computes.  Also the first step's gradient of every parameter against
``jax.grad``."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import model_pair
from video_depth_anything_torch.io.checkpoint import from_jax_params
from video_depth_anything_torch.train.losses import video_depth_loss as t_loss
from video_depth_anything_torch.train.trainer import Trainer as TTrainer
from video_depth_anything_torch.train.trainer import make_optimizer as t_make
from video_depth_anything_tpu.train.losses import video_depth_loss as j_loss
from video_depth_anything_tpu.train.trainer import Trainer as JTrainer
from video_depth_anything_tpu.train.trainer import make_optimizer as j_make
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

LR = 1e-4
STEPS = 3
# Gradients and the first step's metrics: fp32 through two ViT blocks and
# the DPT head, summed in another order (the model parity tests' rtol 1e-3;
# measured under 2e-4).
GRAD_RTOL = 1e-3
METRIC_TOL = dict(rtol=1e-4, atol=1e-7)
# After the first update: Adam's step is ~LR·sign(g) whatever |g|, so a
# parameter whose gradient is at the level of the two frameworks' rounding
# moves either way, and the next gradients shift with it (measured: loss
# 1e-5, gradient norm 1.4e-3 at the second step).
LATER_METRIC_TOL = dict(rtol=5e-3, atol=1e-7)
# Parameters after 3 steps: each moves ≤ ~LR per step; at most 1e-3 of all
# entries may differ by more than 0.05·LR (measured: 4.5e-4 frozen, 4e-6
# trained), none by more than 3·LR.
PARAM_NEAR, PARAM_FAR, PARAM_FRAC = 0.05 * LR, 3 * LR, 1e-3


def batches():
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:28, 0:28] / 27.0
    disp = (0.3 + 0.5 * xx + 0.2 * yy)[None, None].repeat(2, 1).astype(np.float32)
    return [{"frames": rng.randn(1, 2, 28, 28, 3).astype(np.float32),
             "disparity": (disp + 0.05 * rng.rand(1, 2, 28, 28)).astype(np.float32),
             "mask": (rng.rand(1, 2, 28, 28) > 0.1).astype(np.float32)} for _ in range(STEPS)]


@functools.lru_cache(maxsize=None)
def jax_run(train_encoder: bool):
    jm, _ = model_pair("vits", depth=2, seed=3)
    trainer = JTrainer(jm.module, optimizer=j_make(LR, train_encoder=train_encoder),
                       compute_dtype=jnp.float32, remat_encoder=False, train_encoder=train_encoder)
    state = trainer.init_state(jm.params)
    metrics = []
    for b in batches():
        state, m = trainer.step(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, from_jax_params(jax.device_get(state.params), jm.module.cfg)


def check_trainer_steps(train_encoder: bool, remat: bool):
    want_metrics, want_params = jax_run(train_encoder)
    _, tm = model_pair("vits", depth=2, seed=3)
    module = tm.module
    module.cfg = module.head.cfg = dataclasses.replace(module.cfg, remat_motion=remat)
    before = {k: v.clone() for k, v in module.state_dict().items()}
    trainer = TTrainer(module, optimizer=t_make(LR, train_encoder=train_encoder),
                       compute_dtype=torch.float32, remat_encoder=remat,
                       train_encoder=train_encoder)
    for i, (b, want) in enumerate(zip(batches(), want_metrics)):
        got = trainer.step(b)
        for k in ("loss", "ssi", "tgm", "grad_norm"):
            np.testing.assert_allclose(float(got[k]), want[k], err_msg=f"{k} step {i + 1}",
                                       **(METRIC_TOL if i == 0 else LATER_METRIC_TOL))
    assert trainer.global_step == STEPS
    state = module.state_dict()
    diffs = np.concatenate([np.abs(state[n].numpy() - v).ravel() for n, v in want_params.items()])
    assert np.mean(diffs > PARAM_NEAR) <= PARAM_FRAC and diffs.max() <= PARAM_FAR
    moved = {n for n in want_params if not np.array_equal(state[n].numpy(), before[n].numpy())}
    frozen = [n for n in want_params if n.startswith("pretrained.")]
    if train_encoder:
        assert moved & set(frozen)
    else:
        assert not moved & set(frozen)  # bit-identical, no weight decay
    assert any(n.startswith("head.motion_modules.") for n in moved)


def check_first_gradients(train_encoder: bool):
    """Every parameter's gradient of the loss at the first batch, against
    ``jax.grad`` (with the frozen encoder: the head's only, and none for
    the encoder, which runs without grad)."""
    jm, tm = model_pair("vits", depth=2, seed=3)
    b = batches()[0]

    def loss(trainable, frozen):
        pred = jm.module.apply({"params": {**frozen, **trainable}}, jnp.asarray(b["frames"]))
        return j_loss(pred, jnp.asarray(b["disparity"]), jnp.asarray(b["mask"]))[0]

    split = {k: v for k, v in jm.params.items() if train_encoder or k != "pretrained"}
    rest = {k: v for k, v in jm.params.items() if k not in split}
    jg = jax.jit(jax.grad(loss))({k: jax.tree.map(jnp.asarray, v) for k, v in split.items()}, rest)
    if not train_encoder:
        jg["pretrained"] = jax.tree.map(np.zeros_like, jm.params["pretrained"])
    want = from_jax_params(jax.device_get(jg), jm.module.cfg)
    module = tm.module
    pred = module(torch.from_numpy(b["frames"]), freeze_encoder=not train_encoder)
    t_loss(pred, torch.from_numpy(b["disparity"]), torch.from_numpy(b["mask"]))[0].backward()
    for name, p in module.named_parameters():
        if name.startswith("pretrained.") and not train_encoder:
            assert p.grad is None, name
            continue
        got = np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
        w = want[name]
        assert np.linalg.norm(got - w) <= GRAD_RTOL * max(np.linalg.norm(w), 1e-8), name


@pytest.mark.parametrize("remat", [False, True])
def test_trainer_steps_match_jax_frozen_encoder(remat):
    check_trainer_steps(False, remat)


def test_first_gradients_match_jax_frozen_encoder():
    check_first_gradients(False)
