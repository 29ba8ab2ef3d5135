"""``evaluate_dataset`` over real pipelines, the port's against the JAX
package's on the same noised fp32 weights (``model_pair("vits", depth=2)``)
on the CPU: the window pipeline, feature-cache streaming (L = 6, keyframes
(2,)) and KV-cache streaming (L = 6), each behind the eval CLI's adapter (the
JAX ``eval.py:129-170`` adapters do the same), and the window mode with
``align_only_first_frame``.  The synthetic set
holds a 20-frame 36×44 scene with moving cameras (TAE) and a 4-frame one,
shorter than the inference length, that feature-cache streaming skips.
Per-scene metrics, scale, shift and TAE must lie within rtol 1e-3 of JAX's
(the fp32 parity bound, docs/PARITY.md:12).  A mutant that scores
streaming's prediction against the first ``n_out`` ground-truth frames in
place of the last must miss."""

import csv

import numpy as np
import pytest

import chip_smoke
from tests.torch_port_helpers import model_pair, one_torch_thread  # noqa: F401
from video_depth_anything_torch.eval import StreamAdapter
from video_depth_anything_torch.evals.evaluate import evaluate_dataset as t_evaluate
from video_depth_anything_torch.inference import kv_streaming as t_kv
from video_depth_anything_torch.inference import pipeline as t_pipe
from video_depth_anything_torch.inference import streaming as t_stream
from video_depth_anything_tpu.evals.evaluate import evaluate_dataset as j_evaluate
from video_depth_anything_tpu.inference import kv_streaming as j_kv
from video_depth_anything_tpu.inference import pipeline as j_pipe
from video_depth_anything_tpu.inference import streaming as j_stream

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL = 1e-3  # fp32 parity of the JAX package against the torch reference (docs/PARITY.md:12)
H, W = 36, 44
STREAM = dict(input_size=28, inference_length=6, keyframe_list=(2,), chunk_size=4)
KV = dict(input_size=28, inference_length=6, stream_chunk=3)


class Scenes:
    """A 20-frame and a 4-frame scene from ``chip_smoke.scene_frame``;
    the camera slides along x.  ``roll`` shifts every per-frame key by that
    many frames (the mutant)."""

    max_depth = 80.0

    def __init__(self, roll: int = 0):
        self.roll = roll

    def __len__(self):
        return 2

    def __getitem__(self, i):
        n = (20, 4)[i]
        rng = np.random.RandomState(10 + i)
        tilt = rng.uniform(0.5, 2.0, size=2)
        depth, rgb = zip(*(chip_smoke.scene_frame(t, n, H, W, tilt, 0.5, rng) for t in range(n)))
        depth = np.stack(depth).astype(np.float32)
        extr = np.tile(np.eye(4), (n, 1, 1))
        extr[:, 0, 3] = -0.02 * np.arange(n)
        out = {"image": np.stack(rgb), "depth": depth,
               "valid_depth": np.random.RandomState(i).rand(n, H, W) > 0.3,
               "intrinsics": np.tile(np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]]),
                                     (n, 1, 1)),
               "extrinsics": extr, "name": f"scene{i}"}
        for k in ("depth", "valid_depth", "intrinsics", "extrinsics"):
            out[k] = np.roll(out[k], self.roll, axis=0)
        return out


class Memo:
    """A pipeline whose predictions are kept, so that a second evaluation
    of the same scenes reuses them."""

    def __init__(self, inner):
        self.inner, self.preds = inner, {}

    def infer_video_depth(self, frames, *a, **k):
        key = frames.tobytes()
        if key not in self.preds:
            self.preds[key] = self.inner.infer_video_depth(frames)
        return self.preds[key]


@pytest.fixture(scope="module")
def pipes(one_torch_thread):
    jm, tm = model_pair("vits", depth=2, seed=3)
    return {
        "window": (Memo(j_pipe.VideoDepthPipeline(jm, input_size=28)),
                   Memo(t_pipe.VideoDepthPipeline(tm, input_size=28))),
        "feature_cache": (Memo(StreamAdapter(j_stream.StreamingDepthPipeline(jm, **STREAM),
                                             False)),
                          Memo(StreamAdapter(t_stream.StreamingDepthPipeline(tm, **STREAM),
                                             False))),
        "kv_cache": (Memo(StreamAdapter(j_kv.KVStreamingPipeline(jm, **KV), False)),
                     Memo(StreamAdapter(t_kv.KVStreamingPipeline(tm, **KV), False))),
    }


def scene_rows(path):
    """``{scene: [#frames, scale, shift, metrics..., TAE]}`` of a CSV."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    out = {}
    for r in rows[1:]:
        if not r:
            break
        out[r[0]] = [float(x) for x in r[1:]]
    return out


def evaluate_both(pipes, mode, tmp_path, dataset=None, **kw):
    jp, tp = pipes[mode]
    ds = dataset or Scenes()
    j_evaluate(jp, ds, str(tmp_path / "j.csv"), progress=False, **kw)
    t_evaluate(tp, ds, str(tmp_path / "t.csv"), progress=False, **kw)
    return scene_rows(tmp_path / "t.csv"), scene_rows(tmp_path / "j.csv")


@pytest.mark.parametrize("mode,kw", [("window", {}), ("window", {"align_only_first_frame": True}),
                                     ("feature_cache", {}), ("kv_cache", {})])
def test_evaluate_dataset_matches_jax(pipes, tmp_path, mode, kw):
    got, want = evaluate_both(pipes, mode, tmp_path, **kw)
    # feature-cache streaming predicts the last 20 - (6 - 1) frames and
    # nothing for the 4-frame scene
    frames = {"window": [20, 4], "feature_cache": [15], "kv_cache": [20, 4]}[mode]
    assert list(got) == list(want) and [v[0] for v in got.values()] == frames
    for name in want:
        assert np.all(np.isfinite(got[name])) and got[name][-1] > 0  # TAE filled
        np.testing.assert_allclose(got[name], want[name], rtol=RTOL, err_msg=name)


def test_streaming_tail_slicing_mutant_misses(pipes, tmp_path):
    """Scored against GT frames 0..14 in place of 5..19 (the same frames'
    predictions), feature-cache streaming's metrics must leave JAX's."""
    got, want = evaluate_both(pipes, "feature_cache", tmp_path)
    mutant, _ = evaluate_both(pipes, "feature_cache", tmp_path / "mutant",
                              dataset=Scenes(roll=20 - 15))
    np.testing.assert_allclose(got["scene0"], want["scene0"], rtol=RTOL)
    rel = np.abs(np.array(mutant["scene0"]) - want["scene0"]) / np.abs(want["scene0"])
    assert rel.max() > 10 * RTOL, rel
