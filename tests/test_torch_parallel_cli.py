"""The port's CLIs across two spawned gloo ranks on the CPU (``--device
cpu --fp32 --random_init --input_size 28``): ``run --data_parallel``,
``run --pipeline_parallel 2``, ``run --process_single_image --kv_cache
--model_parallel 2`` and ``eval --data_parallel`` on a synthetic Sintel
tree, against the same CLIs in one process; rank 0 alone writes the
outputs, and both ranks print their rank line."""

import csv
import os

import numpy as np
import pytest

import chip_smoke
from tests import torch_parallel_ranks as ranks
from tests.torch_port_helpers import one_torch_thread  # noqa: F401
from video_depth_anything_torch import eval as t_eval
from video_depth_anything_torch import run

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    video = str(tmp / "clip.mp4")
    chip_smoke.write_clip(video, 56, 56, 40)
    sintel = str(tmp / "sintel")
    chip_smoke.write_sintel(sintel, scenes=1, frames=9, h=24, w=56)
    ranks.spawn(ranks.cli_ranks, 2, tmp, video, sintel, str(tmp / "parallel"))
    for name, extra in ranks.CLI_RUNS.items():
        single = [f for f in extra if f != "--data_parallel"]
        single = [f for i, f in enumerate(single)
                  if not (f in ("--pipeline_parallel", "--pp_microbatches", "--model_parallel")
                          or (i and single[i - 1] in ("--pipeline_parallel", "--pp_microbatches",
                                                      "--model_parallel")))]
        assert run.main(ranks.cli_args(video, str(tmp / "single" / name), single)) == 0
    assert t_eval.main(ranks.eval_args(sintel, str(tmp / "single" / "eval.csv"), [])) == 0
    return tmp


def _depth(tmp, side, name):
    return np.load(os.path.join(tmp, side, name, "clip_depth.npz"))["depth"]


@pytest.mark.parametrize("name", list(ranks.CLI_RUNS))
def test_run_cli_across_ranks_matches_one_process(outputs, name):
    got, want = _depth(outputs, "parallel", name), _depth(outputs, "single", name)
    assert got.shape == want.shape and got.shape[1:] == (56, 56)
    if name == "dp":
        np.testing.assert_array_equal(got, want)
    else:
        assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(want).max())


@pytest.mark.parametrize("name", list(ranks.CLI_RUNS))
def test_rank_0_alone_writes(outputs, name):
    assert sorted(os.listdir(os.path.join(outputs, "parallel", name))) == \
        ["clip_depth.mp4", "clip_depth.npz"]


def test_eval_cli_across_ranks_matches_one_process(outputs):
    """Every scene row and the summary bit for bit; of the run's record
    (wall seconds, frames/s, memory) the frame count."""
    def rows(path):
        with open(path) as f:
            table = list(csv.reader(f))
        cut = next(i for i, r in enumerate(table) if r and r[0] == "total_frames")
        return table[:cut], table[cut + 1][0]

    got, want = rows(outputs / "parallel" / "eval.csv"), rows(outputs / "single" / "eval.csv")
    assert got == want and len(want[0]) > 3
