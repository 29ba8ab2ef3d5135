"""``python -m video_depth_anything_torch.eval`` on the CPU (``main`` called
in-process, ``--device cpu --random_init --input_size 28``) over synthetic
KITTI and Sintel trees in the window, ``--streaming`` and ``--streaming
--kv_cache`` modes: the CSV has the JAX CSV's header and summary rows, a
finite row for every scene, and TAE where the dataset has cameras.  Also
the JAX ``eval.py``'s flags, ``normalize_args``
against the root ``eval.normalize_args``, the mode and ``skip_tmp_block``
binding, ``--checkpoint`` against ``--random_init`` on the same weights and
the refusal without a card."""

import csv
import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
from tests.torch_port_helpers import one_torch_thread  # noqa: F401
from video_depth_anything_torch import eval as t_eval
from video_depth_anything_torch.inference.kv_streaming import KVStreamingPipeline
from video_depth_anything_torch.inference.streaming import StreamingDepthPipeline
from video_depth_anything_torch.io.checkpoint import save_pth
from video_depth_anything_tpu.evals.metrics import HEADER

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST = ["--device", "cpu", "--random_init", "--input_size", "28", "--inference_length", "6",
        "--keyframe_list", "2"]


def root_eval():
    spec = importlib.util.spec_from_file_location("root_eval_cli", os.path.join(ROOT, "eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    kitti, sintel = str(root / "kitti"), str(root / "sintel")
    chip_smoke.write_kitti(kitti, drives=1, frames=9, h=24, w=80)
    chip_smoke.write_sintel(sintel, scenes=1, frames=9, h=24, w=56)
    return {"kitti": kitti, "sintel": sintel}


def read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


MODES = {"window": [], "streaming": ["--streaming"], "kv_cache": ["--streaming", "--kv_cache"]}


@pytest.mark.parametrize("dataset", ["kitti", "sintel"])
@pytest.mark.parametrize("mode", list(MODES))
def test_eval_cli_writes_the_jax_csv(trees, tmp_path, capsys, dataset, mode):
    path = str(tmp_path / "m.csv")
    dtype = ["--fp32"] if mode != "window" else []  # the window runs bf16 on the CPU
    assert t_eval.main(["--dataset", dataset, "--root", trees[dataset], "--csv", path,
                        *FAST, *MODES[mode], *dtype]) == 0
    rows = read_csv(path)
    names = ["2011_09_26_drive_0001_sync_image_03", "2011_09_26_drive_0001_sync_image_02"] \
        if dataset == "kitti" else ["alley_1"]
    n = {"window": 9, "streaming": 9 - 5, "kv_cache": 9}[mode]
    assert rows[0] == HEADER
    assert [r[0] for r in rows[1:len(names) + 1]] == names
    for r in rows[1:len(names) + 1]:
        assert int(r[1]) == n
        vals = [float(x) for x in r[2:11]]
        assert np.all(np.isfinite(vals))
        # KITTI has no extrinsics: no TAE; Sintel's cameras give one
        assert (r[11] == "") if dataset == "kitti" else float(r[11]) > 0
    tail = rows[len(names) + 1:]
    assert tail[0] == [] and tail[1][0] == "Overall Mean" and tail[2][0] == "Overall Variance"
    assert len(tail[1]) == len(tail[2]) == len(HEADER)
    assert tail[3] == [] and tail[4] == ["total_frames", "wall_s", "fps", "host_rss_mb"]
    assert int(tail[5][0]) == n * len(names) and float(tail[5][2]) > 0
    out = capsys.readouterr().out.splitlines()
    result = json.loads(out[-2])
    assert result["frames"] == n * len(names) and result["csv"] == path
    launches = json.loads(out[-1].split(": ", 1)[1])
    assert launches and not any(launches.values())  # the CPU path launches no kernel


def test_eval_flags_match_jax(capsys):
    with pytest.raises(SystemExit):
        root_eval().main(["--help"])
    jax_flags = set(re.findall(r"--\w+", capsys.readouterr().out))
    port_flags = {a for act in t_eval.build_parser()._actions for a in act.option_strings
                  if a.startswith("--")}
    assert jax_flags == port_flags - {"--device"}
    jax_defaults = {"--inference_length": 32, "--keyframe_list": [20], "--stream_chunk": 8,
                    "--input_size": 518, "--encoder": "vits", "--device": "cuda"}
    args = t_eval.build_parser().parse_args(["--dataset", "sintel", "--root", "r", "--csv", "c"])
    for flag, want in jax_defaults.items():
        assert getattr(args, flag[2:]) == want, flag
    with pytest.raises(SystemExit):
        t_eval.build_parser().parse_args(["--dataset", "nope", "--root", "r", "--csv", "c"])


@pytest.mark.parametrize("flags", [[], ["--original"], ["--streaming", "--skip_tmp_block"],
                                   ["--original", "--streaming", "--skip_tmp_block"],
                                   ["--skip_tmp_block"]])
def test_normalize_args_matches_root_eval(flags):
    args = t_eval.build_parser().parse_args(["--dataset", "kitti", "--root", "r", "--csv", "c",
                                             *flags])

    class A:
        original = "--original" in flags
        streaming = "--streaming" in flags
        skip_tmp_block = "--skip_tmp_block" in flags

    want = root_eval().normalize_args(A())
    got = t_eval.normalize_args(args)
    assert (got.streaming, got.skip_tmp_block) == (want.streaming, want.skip_tmp_block)


def test_build_pipeline_modes_and_skip_tmp_block():
    def args(*flags):
        return t_eval.normalize_args(t_eval.build_parser().parse_args(
            ["--dataset", "kitti", "--root", "r", "--csv", "c", *FAST, *flags]))

    model = t_eval.load_model(args("--fp32"))
    pipe = t_eval.build_pipeline(args("--skip_tmp_block"), model)
    assert pipe.infer_video_depth.keywords == {"skip_tmp_block": True}
    assert not hasattr(t_eval.build_pipeline(args(), model).infer_video_depth, "keywords")
    s = t_eval.build_pipeline(args("--streaming", "--skip_tmp_block", "--stream_chunk", "3",
                                   "--align_each_new_frame"), model)
    assert isinstance(s.inner, StreamingDepthPipeline) and s.skip_tmp_block
    assert (s.inner.L, s.inner.keyframes, s.inner.chunk, s.inner.align) == (6, (2,), 3, True)
    kv = t_eval.build_pipeline(args("--streaming", "--kv_cache"), model)
    assert isinstance(kv.inner, KVStreamingPipeline) and not kv.skip_tmp_block
    assert (kv.inner.L, kv.inner.chunk) == (6, 8)
    # --original wins over --streaming and --skip_tmp_block
    plain = t_eval.build_pipeline(args("--original", "--streaming", "--skip_tmp_block"), model)
    assert not hasattr(plain.infer_video_depth, "keywords") and not hasattr(plain, "inner")


def test_checkpoint_matches_random_init(trees, tmp_path):
    base = ["--dataset", "sintel", "--root", trees["sintel"], *FAST[:2], "--input_size", "28",
            "--fp32", "--max_frames_per_scene", "7", "--align_only_first_frame"]
    model = t_eval.load_model(t_eval.build_parser().parse_args(
        base[:4] + ["--csv", "x", "--random_init", "--device", "cpu", "--encoder", "vits"]))
    ckpt = str(tmp_path / "w.pth")
    save_pth(ckpt, model.module.state_dict())
    a, b = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    assert t_eval.main(base + ["--random_init", "--csv", a]) == 0
    assert t_eval.main(base + ["--checkpoint", ckpt, "--csv", b]) == 0
    rows_a, rows_b = read_csv(a), read_csv(b)
    assert rows_a[1][:2] == ["alley_1", "7"] and rows_a[:-1] == rows_b[:-1]


def test_eval_refuses_without_a_card(trees, tmp_path):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_eval.main(["--dataset", "sintel", "--root", trees["sintel"], "--csv",
                     str(tmp_path / "m.csv"), "--random_init"])
