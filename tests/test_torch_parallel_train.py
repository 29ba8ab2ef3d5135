"""Data-parallel and ZeRO-1 training over two spawned gloo ranks on the CPU
(``train/trainer.py`` with a ``parallel/mesh.Grid``): every rank draws the
global batch of two clips and takes its clip; the first step's metrics and
(summed) gradients against the single-process step on the global batch,
the loss against JAX's on the same batch (rtol 1e-3); ZeRO-1 bit for bit
the unsharded optimizer; and a checkpoint saved under ZeRO-1 at world size
2 resumed at world size 1.

The ranks' gradients are bit for bit those of the same split computed in
one process (``torch_parallel_ranks.split_batch_grads``: each clip forward
and backward alone, the gradients summed); against the single-process step
they are held to 1e-5 of each tensor's largest gradient, or four times that
split's own distance where these noised weights amplify the batch-size
rounding of the GEMMs past it."""

import copy
import os

import numpy as np
import pytest
import torch

from tests import torch_parallel_ranks as ranks
from tests.torch_port_helpers import model_pair, one_torch_thread  # noqa: F401
from video_depth_anything_torch.train.trainer import Trainer, make_optimizer

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CASES = ((False, False), (True, False), (True, True))  # (zero1, train_encoder)


def batch_of(seed: int):
    rng = np.random.default_rng(seed)
    return {"frames": rng.standard_normal((2, 3, 28, 28, 3)).astype(np.float32),
            "disparity": (rng.random((2, 3, 28, 28)) + 0.5).astype(np.float32),
            "mask": (rng.random((2, 3, 28, 28)) > 0.2).astype(np.float32)}


def single_step(tm, batch, train_encoder):
    model = copy.deepcopy(tm)
    trainer = Trainer(model.module, make_optimizer(1e-3, train_encoder=train_encoder),
                      compute_dtype=torch.float32, train_encoder=train_encoder)
    m = trainer.step(batch)
    return trainer, m, {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                        for n, p in trainer.params.items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    jm, tm = model_pair("vits", depth=4, seed=8)
    torch.save(tm.module.state_dict(), tmp / "state.pt")
    batch = batch_of(9)
    np.savez(tmp / "batch.npz", **batch)
    ranks.spawn(ranks.train_steps, 2, tmp, "vits", 4, str(tmp / "state.pt"),
                str(tmp / "batch.npz"), str(tmp), 1, CASES)
    single = {enc: single_step(tm, batch, enc) for enc in (False, True)}
    split = {enc: ranks.split_batch_grads(copy.deepcopy(tm).module, batch, 2, enc)
             for enc in (False, True)}
    return tmp, batch, single, tm, jm, split


@pytest.mark.parametrize("zero1,enc", CASES)
def test_first_step_metrics_match_single_process(run, zero1, enc):
    tmp, _, single, _, _, split = run
    _, m, grads = single[enc]
    want = np.array([float(m[k]) for k in ("loss", "ssi", "tgm", "grad_norm")])
    from video_depth_anything_torch.train.trainer import global_norm

    split_norm = float(global_norm(list(split[enc][1].values())))
    rtol = ranks.floor_tol(np.array([split[enc][0], split_norm]), want[[0, 3]])
    assert rtol <= 2e-4
    for r in range(2):
        got = ranks.load(tmp, f"{ranks.train_tag(1, zero1, enc)}_metrics", r)[0]
        np.testing.assert_allclose(got, want, rtol=rtol)
        np.testing.assert_allclose(got[[0, 3]], [split[enc][0], split_norm], rtol=1e-6)


@pytest.mark.parametrize("zero1,enc", CASES)
def test_summed_gradients_are_the_split_batch(run, zero1, enc):
    tmp, _, single, _, _, split = run
    got = torch.load(os.path.join(tmp, f"{ranks.train_tag(1, zero1, enc)}_grads.pt"),
                     weights_only=True)
    assert set(got) == set(split[enc][1]) == set(single[enc][2])
    for n, g in split[enc][1].items():
        assert torch.equal(got[n], g), n


@pytest.mark.parametrize("zero1,enc", CASES)
def test_summed_gradients_match_single_process(run, zero1, enc):
    tmp, _, single, _, _, split = run
    want = single[enc][2]
    got = torch.load(os.path.join(tmp, f"{ranks.train_tag(1, zero1, enc)}_grads.pt"),
                     weights_only=True)
    for n, g in want.items():
        scale = float(g.abs().max()) + 1e-30
        tol = ranks.floor_tol(split[enc][1][n].numpy() / scale, g.numpy() / scale)
        assert tol <= 2e-3 and float((got[n] - g).abs().max()) <= tol * scale, n


def test_zero1_is_the_unsharded_optimizer_bit_for_bit(run):
    """Two steps with and without ZeRO-1 at world size 2: the same
    metrics, parameters and (gathered) moments, bit for bit."""
    tmp = run[0]
    a, b = (torch.load(os.path.join(tmp, f"{ranks.train_tag(1, z, False)}.pt"),
                       weights_only=True) for z in (False, True))
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    for part in ("mu", "nu"):
        assert set(a["opt_state"][part]) == set(b["opt_state"][part])
        for k, v in a["opt_state"][part].items():
            assert torch.equal(v, b["opt_state"][part][k]), (part, k)
    assert a["step"] == b["step"] == 2 and b["opt_state"]["count"] == 2
    np.testing.assert_array_equal(
        ranks.load(tmp, f"{ranks.train_tag(1, False, False)}_metrics", 0),
        ranks.load(tmp, f"{ranks.train_tag(1, True, False)}_metrics", 0))


@pytest.mark.parametrize("enc", [False, True])
def test_zero1_shards_the_moments(run, enc):
    """Every rank holds a shard of the moments of the leaves with a
    dimension divisible by two, and none without ZeRO-1."""
    tmp, _, single, _, _, _ = run
    names = set(single[enc][0].params)
    for r in range(2):
        views = set(ranks.load(tmp, f"{ranks.train_tag(1, True, enc)}_views", r).tolist())
        assert views and views <= names
        assert any(n.startswith("pretrained.") for n in views) == enc
    assert ranks.load(tmp, f"{ranks.train_tag(1, False, False)}_views", 0).size == 0


def test_zero1_checkpoint_resumes_at_world_size_1(run):
    """The state saved under ZeRO-1 at world size 2 holds whole moments and
    loads into a single-process trainer, which steps on from it."""
    tmp, batch, _, tm, _, _ = run
    path = os.path.join(tmp, f"{ranks.train_tag(1, True, True)}.pt")
    saved = torch.load(path, weights_only=True)
    model = copy.deepcopy(tm)
    trainer = Trainer(model.module, make_optimizer(1e-3, train_encoder=True),
                      compute_dtype=torch.float32, train_encoder=True)
    trainer.restore_state(path)
    assert trainer.global_step == 2
    for k, v in model.module.state_dict().items():
        assert torch.equal(v, saved["params"][k]), k
    for n, p in trainer.params.items():
        assert trainer.opt_state["mu"][n].shape == p.shape
        assert torch.equal(trainer.opt_state["mu"][n], saved["opt_state"]["mu"][n])
    m = trainer.step(batch)
    assert trainer.global_step == 3 and trainer.opt_state["count"] == 3
    assert all(np.isfinite(float(v)) for v in m.values())


def test_data_parallel_loss_matches_jax(run):
    import jax.numpy as jnp

    from video_depth_anything_tpu.train.losses import video_depth_loss

    tmp, batch, _, _, jm, _ = run
    pred = jnp.asarray(jm.infer_window(batch["frames"]), jnp.float32)
    want, _ = video_depth_loss(pred, jnp.asarray(batch["disparity"]), jnp.asarray(batch["mask"]))
    got = ranks.load(tmp, f"{ranks.train_tag(1, True, False)}_metrics", 0)[0][0]
    np.testing.assert_allclose(got, float(want), rtol=1e-3)
