"""The port's training losses against the JAX package's
(``train/losses.py``) on the same seeded inputs, in fp32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_depth_anything_torch.train import losses as t_losses
from video_depth_anything_tpu.train import losses as j_losses
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# fp32 sums over a few thousand elements, in another order
TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(seed, shape=(2, 4, 12, 16)):
    rng = np.random.RandomState(seed)
    pred = rng.rand(*shape).astype(np.float32)
    target = (1.7 * pred + 0.3 + 0.05 * rng.randn(*shape)).astype(np.float32)
    mask = (rng.rand(*shape) > 0.25).astype(np.float32)
    mask[0, 1] = 0.0  # a frame with no valid pixel: the degenerate fit
    return pred, target, mask


@pytest.mark.parametrize("name", ["masked_scale_shift", "ssi_loss", "tgm_loss"])
def test_loss_matches_jax(name):
    arrays = _inputs(0)
    want = getattr(j_losses, name)(*map(jnp.asarray, arrays))
    got = getattr(t_losses, name)(*map(torch.from_numpy, arrays))
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("tgm_weight", [0.0, 10.0])
def test_video_depth_loss_and_gradient_match_jax(tgm_weight):
    import jax

    pred, target, mask = _inputs(1)
    total, metrics = j_losses.video_depth_loss(*map(jnp.asarray, (pred, target, mask)), tgm_weight)
    jgrad = jax.grad(lambda p: j_losses.video_depth_loss(
        p, jnp.asarray(target), jnp.asarray(mask), tgm_weight)[0])(jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_()
    t_total, t_metrics = t_losses.video_depth_loss(
        tp, torch.from_numpy(target), torch.from_numpy(mask), tgm_weight)
    t_total.backward()
    np.testing.assert_allclose(t_total.item(), float(total), **TOL)
    for k in ("loss", "ssi", "tgm"):
        np.testing.assert_allclose(t_metrics[k].item(), float(metrics[k]), **TOL)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgrad), rtol=1e-4, atol=1e-7)
