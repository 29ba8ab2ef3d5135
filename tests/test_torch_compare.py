"""``python -m video_depth_anything_torch.compare`` against the root
``compare.py`` on the CPU (both ``main`` in-process): from the same
``--method`` depth files (npz and a TIFF stack, methods of different
lengths, with and without ``--gt_npz``) ``comparison.json`` must be equal,
and the two renderings' frames, captured by patching ``save_video`` in
both packages' ``evals/visualize``, equal pixel for pixel.  Also the steps
before the renderings (``run_methods``: ``--run`` through ``python -m
video_depth_anything_torch.run --device cpu`` subprocesses on noised
weights; ``score_methods``), the flags, and the refusal without a card."""

import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
from tests.torch_port_helpers import one_torch_thread  # noqa: F401
from video_depth_anything_torch import compare as t_compare
from video_depth_anything_torch.evals import visualize as t_vis
from video_depth_anything_torch.io.video import write_tiff_stack
from video_depth_anything_tpu.evals import visualize as j_vis

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, H, W = 8, 48, 64


def root_compare():
    spec = importlib.util.spec_from_file_location("root_compare_cli",
                                                  os.path.join(ROOT, "compare.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A clip and three methods' depths: npz (8 frames), npz of the last 5
    frames (as streaming emits), a TIFF stack; and a GT npz."""
    root = tmp_path_factory.mktemp("compare")
    video = str(root / "clip.mp4")
    chip_smoke.write_clip(video, H, W, N)
    rng = np.random.RandomState(0)
    gt = rng.uniform(1.0, 10.0, (N, H, W)).astype(np.float32)
    files = {}
    for name, depth in (("base", 2.0 / gt + 0.1), ("stream", 1.5 / gt[3:] + 0.3)):
        depth = depth + rng.standard_normal(depth.shape).astype(np.float32) * 0.01
        files[name] = str(root / f"{name}.npz")
        np.savez(files[name], depth=depth.astype(np.float32))
    files["tiff"] = str(root / "tiff.tiff")
    write_tiff_stack(files["tiff"], (0.5 / gt + rng.rand(N, H, W) * 0.01).astype(np.float32))
    np.savez(str(root / "gt.npz"), other=gt)  # no "depth" key: the first array is taken
    return video, files, str(root / "gt.npz")


def capture(monkeypatch, module):
    frames = {}

    def save_video(f, path, fps=10, **kw):
        frames[os.path.basename(path)] = (np.asarray(f), fps)

    monkeypatch.setattr(module, "save_video", save_video)
    return frames


@pytest.mark.parametrize("with_gt", [False, True])
def test_compare_matches_root_compare(inputs, tmp_path, monkeypatch, with_gt):
    monkeypatch.setenv("VDA_NATIVE_DECODE", "0")  # JAX decodes through cv2, as the port
    video, files, gt = inputs
    args = ["--video", video, *(a for n, p in files.items() for a in ("--method", f"{n}={p}")),
            "--max_frames", "3", "--fps", "12"] + (["--gt_npz", gt] if with_gt else [])
    got_frames, want_frames = capture(monkeypatch, t_vis), capture(monkeypatch, j_vis)
    assert t_compare.main(args + ["--out_dir", str(tmp_path / "t"), "--device", "cpu"]) == 0
    assert root_compare().main(args + ["--out_dir", str(tmp_path / "j")]) == 0
    got = json.load(open(tmp_path / "t" / "comparison.json"))
    assert got == json.load(open(tmp_path / "j" / "comparison.json"))
    assert got["reference"] == ("gt" if with_gt else "base")
    assert [m["frames"] for m in got["methods"].values()] == [N, N - 3, N]
    assert sorted(got_frames) == sorted(want_frames) == ["clip_compare.mp4", "clip_money.mp4"]
    for name, (frames, fps) in want_frames.items():
        assert frames.dtype == np.uint8 and frames.shape[0] == 3 and fps == 12
        np.testing.assert_array_equal(got_frames[name][0], frames, err_msg=name)
        assert got_frames[name][1] == fps


def test_renderers_match_jax(monkeypatch):
    rng = np.random.RandomState(1)
    rgb = rng.randint(0, 256, (3, 20, 24, 3)).astype(np.uint8)
    preds = {"a": rng.rand(4, 20, 24).astype(np.float32), "b": rng.rand(3, 20, 24) * 2}
    gt = rng.rand(3, 20, 24)
    for args in ((rgb, gt, preds), (rgb, None, {"a": preds["a"]})):
        got_frames, want_frames = capture(monkeypatch, t_vis), capture(monkeypatch, j_vis)
        t_vis.render_comparison_video(*args, "x.mp4", stability_line=0.25, max_frames=2)
        j_vis.render_comparison_video(*args, "x.mp4", stability_line=0.25, max_frames=2)
        np.testing.assert_array_equal(got_frames["x.mp4"][0], want_frames["x.mp4"][0])
        np.testing.assert_array_equal(
            t_vis.comparison_frames(*args, stability_line=0.25, max_frames=2),
            want_frames["x.mp4"][0])
    t_vis.render_money_plot(rgb, preds, "m.mp4", fps=5)
    j_vis.render_money_plot(rgb, preds, "m.mp4", fps=5)
    np.testing.assert_array_equal(got_frames["m.mp4"][0], want_frames["m.mp4"][0])
    np.testing.assert_array_equal(t_vis.money_plot_frames(rgb, preds), want_frames["m.mp4"][0])
    d = rng.rand(5, 6, 7)
    np.testing.assert_array_equal(t_vis._stability_slice(d, 0.3), j_vis._stability_slice(d, 0.3))


def test_helpers_match_root_compare(inputs):
    _, files, gt = inputs
    root = root_compare()
    for path in (*files.values(), gt):
        np.testing.assert_array_equal(t_compare._load_depth_npz(path), root._load_depth_npz(path))
    pred, ref = t_compare._load_depth_npz(files["base"]), t_compare._load_depth_npz(gt)
    np.testing.assert_array_equal(t_compare.first_frame_align(pred, ref),
                                  root.first_frame_align(pred, ref))


def test_no_render_and_runs(inputs, tmp_path, capsys):
    """Two ``--run`` subprocesses of the port's run CLI on the CPU over one
    checkpoint of noised weights (no motion module is the identity), with
    and without ``--skip_tmp_block``; ``score_methods`` alone writes only
    ``comparison.json``, whose rows are the first-frame alignment of the two
    npz files computed here."""
    from video_depth_anything_torch.evals.metrics import abs_diff
    from video_depth_anything_torch.io.checkpoint import save_pth
    from video_depth_anything_torch.models.vda import VDAModel

    video, _, _ = inputs
    model = VDAModel("vits", device="cpu", dtype=torch.float32)
    model.init_params(seed=0)
    chip_smoke.noise_weights(model.module, seed=1)
    ckpt = str(tmp_path / "noised.pth")
    save_pth(ckpt, model.module.state_dict())
    out = tmp_path / "out"
    flags = f"--checkpoint {ckpt} --input_size 28 --fp32"
    methods = t_compare.run_methods(video, [f"base:{flags}", f"skip:{flags} --skip_tmp_block"],
                                    str(out), "cpu")
    _, rows = t_compare.score_methods(methods, None, str(out))
    printed = capsys.readouterr().out
    assert printed.count("-m video_depth_anything_torch.run") == 2 and " run.py " not in printed
    report = json.load(open(out / "comparison.json"))
    assert report == {"reference": "base", "methods": rows}
    assert list(rows) == ["base", "skip"] and rows["skip"]["frames"] == N
    base, skip = (np.load(out / f"run_{m}" / "clip_depth.npz")["depth"] for m in ("base", "skip"))
    scale = float(np.abs(base).mean())
    assert rows["base"]["abs_vs_ref"] < 1e-6 * scale
    assert rows["skip"]["abs_vs_ref"] == abs_diff(t_compare.first_frame_align(skip, base), base)
    assert rows["skip"]["abs_vs_ref"] > 1e-2 * scale
    assert sorted(os.listdir(out)) == ["comparison.json", "run_base", "run_skip"]


def test_compare_flags_and_refusals(inputs, tmp_path, capsys):
    with pytest.raises(SystemExit):
        root_compare().main(["--help"])
    jax_flags = set(re.findall(r"--\w+", capsys.readouterr().out))
    port_flags = {a for act in t_compare.build_parser()._actions for a in act.option_strings
                  if a.startswith("--")}
    assert port_flags - {"--device"} == jax_flags
    video, files, _ = inputs
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_compare.main(["--video", video, "--method", f"base={files['base']}", "--out_dir",
                        str(tmp_path)])
    with pytest.raises(SystemExit):  # no method
        t_compare.main(["--video", video, "--device", "cpu", "--out_dir", str(tmp_path)])
