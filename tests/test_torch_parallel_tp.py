"""Tensor parallelism over spawned gloo ranks on the CPU
(``parallel/mesh.shard_module``): a vits window (6 heads; 3 a rank at two
ranks, 2, 2, 1, 1 at four) against the port's single-process forward and
JAX's (rtol 1e-3), every rank holding the same depth, the shards gathered
back to the whole state, and two wrong splits (a contiguous block of the
fused qkv rows a rank, the row-parallel bias on every rank) each missing by
more than 1e-3.

The bound against the single-process forward is 1e-5 or, where larger,
four times the distance of the same forward with its row-parallel sums
split as the ranks split them (``torch_parallel_ranks.split_sums``): these
noised weights amplify that fp32 reassociation to 2-4e-5 (vits depth 4).
At two ranks the ranks' result is that split forward's bit for bit."""

import copy

import numpy as np
import pytest
import torch

from tests import torch_parallel_ranks as ranks
from tests.torch_port_helpers import model_pair, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    jm, tm = model_pair("vits", depth=4, seed=3)
    torch.save(tm.module.state_dict(), tmp / "state.pt")
    x = np.random.default_rng(0).standard_normal((1, 4, 28, 28, 3)).astype(np.float32)
    np.save(tmp / "x.npy", x)
    for n in WORLDS:
        out = tmp / f"w{n}"
        out.mkdir()
        ranks.spawn(ranks.tp_window, n, tmp, "vits", 4, str(tmp / "state.pt"),
                    str(tmp / "x.npy"), str(out))
    single = tm.infer_window(x).numpy()
    split = {n: ranks.split_sums(copy.deepcopy(tm).module, n) for n in WORLDS}
    with torch.inference_mode():
        split = {n: m(torch.as_tensor(x)).numpy() for n, m in split.items()}
    jax_depth = np.asarray(jm.infer_window(x), np.float32)
    return tmp, single, jax_depth, split


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("n", WORLDS)
def test_tp_window_matches_single_process(run, n):
    tmp, single, _, split = run
    tol = ranks.floor_tol(split[n], single)
    assert tol <= 2e-4 and _rel(ranks.load(tmp / f"w{n}", "tp_None", 0), single) <= tol


def test_tp_window_is_the_split_sums_bit_for_bit(run):
    """gloo's sum of two partial products is their sum in rank order."""
    tmp, _, _, split = run
    np.testing.assert_array_equal(ranks.load(tmp / "w2", "tp_None", 0), split[2])


@pytest.mark.parametrize("n", WORLDS)
def test_tp_window_matches_jax(run, n):
    tmp, _, jax_depth, _ = run
    np.testing.assert_allclose(ranks.load(tmp / f"w{n}", "tp_None", 0), jax_depth, rtol=1e-3,
                               atol=1e-3 * np.abs(jax_depth).max())


@pytest.mark.parametrize("n", WORLDS)
def test_every_rank_holds_the_same_depth(run, n):
    tmp = run[0] / f"w{n}"
    first = ranks.load(tmp, "tp_None", 0)
    for r in range(1, n):
        np.testing.assert_array_equal(ranks.load(tmp, "tp_None", r), first)


@pytest.mark.parametrize("n", WORLDS)
def test_heads_split_whole_and_uneven(run, n):
    want = [len(a) for a in np.array_split(np.arange(6), n)]
    for r in range(n):
        assert set(ranks.load(run[0] / f"w{n}", "tp_heads", r)) == {want[r]}


@pytest.mark.parametrize("n", WORLDS)
def test_shards_gather_back_whole(run, n):
    assert all(bool(ranks.load(run[0] / f"w{n}", "tp_state_roundtrip", r)) for r in range(n))


@pytest.mark.parametrize("mutant", ["contiguous_qkv", "bias_every_rank"])
@pytest.mark.parametrize("n", WORLDS)
def test_wrong_splits_miss(run, n, mutant):
    tmp, single, jax_depth, split = run
    got = ranks.load(tmp / f"w{n}", f"tp_{mutant}", 0)
    assert _rel(got, single) > max(1e-3, 10 * ranks.floor_tol(split[n], single))
    assert _rel(got, jax_depth) > 1e-3
