"""Tensor-parallel training over spawned gloo ranks on the CPU: the encoder
trained and split over model groups of two (``parallel/mesh.shard_module``:
column-parallel inputs' gradients summed over the group, row-parallel
biases once), at world size 2 (one model group) and 4 (two data groups,
ZeRO-1 over them).  The first step's metrics and gradients (shards gathered
whole) against the single-process step on the global batch, within 1e-5 or
four times the distance of the same step with its row-parallel sums and its
batch split as the ranks split them (``split_sums``, ``split_batch_grads``)
where these noised weights amplify that reassociation; the checkpoint holds
whole tensors and resumes at world size 1."""

import copy

import numpy as np
import pytest
import torch

from tests import torch_parallel_ranks as ranks
from tests.test_torch_parallel_train import batch_of, single_step
from tests.torch_port_helpers import model_pair, one_torch_thread  # noqa: F401
from video_depth_anything_torch.train.trainer import Trainer, global_norm, make_optimizer

pytestmark = pytest.mark.usefixtures("one_torch_thread")

WORLDS = {2: False, 4: True}  # world size: zero1, at model_parallel 2


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_tp")
    _, tm = model_pair("vits", depth=4, seed=10)
    torch.save(tm.module.state_dict(), tmp / "state.pt")
    batch = batch_of(11)
    np.savez(tmp / "batch.npz", **batch)
    for n, zero1 in WORLDS.items():
        out = tmp / f"w{n}"
        out.mkdir()
        ranks.spawn(ranks.train_steps, n, tmp, "vits", 4, str(tmp / "state.pt"),
                    str(tmp / "batch.npz"), str(out), 2, ((zero1, True),))
    single = single_step(tm, batch, True)
    split = {n: ranks.split_batch_grads(ranks.split_sums(copy.deepcopy(tm).module, 2), batch,
                                        n // 2, True) for n in WORLDS}
    return tmp, batch, single, split, tm


def _tag(n):
    return ranks.train_tag(2, WORLDS[n], True)


@pytest.mark.parametrize("n", list(WORLDS))
def test_first_step_metrics_match_single_process(run, n):
    tmp, _, (_, m, _), split, _ = run
    want = np.array([float(m[k]) for k in ("loss", "ssi", "tgm", "grad_norm")])
    split_norm = float(global_norm(list(split[n][1].values())))
    rtol = ranks.floor_tol(np.array([split[n][0], split_norm]), want[[0, 3]])
    assert rtol <= 2e-4
    for r in range(n):
        got = ranks.load(tmp / f"w{n}", f"{_tag(n)}_metrics", r)[0]
        np.testing.assert_allclose(got, want, rtol=rtol)


@pytest.mark.parametrize("n", list(WORLDS))
def test_gathered_gradients_match_single_process(run, n):
    tmp, _, (_, _, want), split, _ = run
    got = torch.load(tmp / f"w{n}" / f"{_tag(n)}_grads.pt", weights_only=True)
    assert set(got) == set(want)
    for k, g in want.items():
        assert got[k].shape == g.shape, k
        scale = float(g.abs().max()) + 1e-30
        tol = ranks.floor_tol(split[n][1][k].numpy() / scale, g.numpy() / scale)
        assert tol <= 2e-3 and float((got[k] - g).abs().max()) <= tol * scale, k


def test_zero1_never_shards_a_tensor_parallel_dimension(run):
    """At world 4 the moments of the split encoder tensors are sharded over
    the data group on another dimension than the model group's."""
    views = set(ranks.load(run[0] / "w4", f"{_tag(4)}_views", 0).tolist())
    assert any(".attn.qkv.weight" in v for v in views)
    assert ranks.load(run[0] / "w2", f"{_tag(2)}_views", 0).size == 0


@pytest.mark.parametrize("n", list(WORLDS))
def test_checkpoint_is_whole_and_resumes_at_world_size_1(run, n):
    tmp, batch, _, _, tm = run
    path = tmp / f"w{n}" / f"{_tag(n)}.pt"
    saved = torch.load(path, weights_only=True)
    whole = tm.module.state_dict()
    assert {k: v.shape for k, v in saved["params"].items()} == {k: v.shape
                                                                for k, v in whole.items()}
    model = copy.deepcopy(tm)
    trainer = Trainer(model.module, make_optimizer(1e-3, train_encoder=True),
                      compute_dtype=torch.float32, train_encoder=True)
    trainer.restore_state(str(path))
    for k, p in trainer.params.items():
        assert trainer.opt_state["nu"][k].shape == p.shape, k
    m = trainer.step(batch)
    assert trainer.global_step == 3 and all(np.isfinite(float(v)) for v in m.values())
