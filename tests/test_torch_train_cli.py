"""``python -m video_depth_anything_torch.train`` on the CPU (called
in-process through ``main``): two steps of vits on a synthetic
PointOdyssey tree with validation and checkpoints, then a resume for two
more; the multi-GPU flags refuse."""

import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from video_depth_anything_torch.io.checkpoint import load_pth
from video_depth_anything_torch.train.__main__ import main
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _args(root, out, steps, *extra):
    return ["--dataset", "pointodyssey", "--root", root, "--device", "cpu", "--encoder", "vits",
            "--input_size", "28", "--clip_len", "2", "--steps", str(steps), "--out", out,
            "--log_every", "1", "--save_every", "2", "--train_encoder", *extra]


def test_train_then_resume(tmp_path):
    root, out = str(tmp_path / "po"), str(tmp_path / "out")
    chip_smoke.write_pointodyssey(root, scenes=2, frames=5, h=36, w=64)
    assert main(_args(root, out, 2, "--eval_every", "2")) == 0
    assert main(_args(root, out, 4, "--resume")) == 0
    lines = [json.loads(x) for x in open(os.path.join(out, "train_log.jsonl"))]
    assert [x["step"] for x in lines] == [1, 2, 3, 4]
    for x in lines:
        assert all(np.isfinite(x[k]) for k in ("loss", "ssi", "tgm", "grad_norm", "sps"))
    assert {"val_absrel_disp", "val_delta1_disp"} <= lines[1].keys()
    state = torch.load(os.path.join(out, "state_latest.pt"), weights_only=True)
    assert state["step"] == 4 and state["opt_state"]["count"] == 4
    # the step weights are a reference-keyed state dict the port loads strictly
    weights = load_pth(os.path.join(out, "step_0000004.pth"))
    assert "pretrained.blocks.11.attn.qkv.weight" in weights
    torch.testing.assert_close(weights["head.scratch.output_conv1.weight"],
                               state["params"]["head.scratch.output_conv1.weight"])


def test_orbax_directory_refused(tmp_path):
    root = str(tmp_path / "po")
    chip_smoke.write_pointodyssey(root, scenes=1, frames=3, h=36, w=64)
    os.makedirs(tmp_path / "native")
    with pytest.raises(ValueError, match="orbax"):
        main(_args(root, str(tmp_path / "out"), 1, "--init_checkpoint", str(tmp_path / "native")))
