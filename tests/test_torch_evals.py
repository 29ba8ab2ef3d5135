"""The port's evaluation layer against the JAX package's on seeded maps:
the metrics (numpy, rtol 1e-6; ``compute_all_torch`` against
``compute_all_jax``, rtol 1e-5), the alignment (``fit_inverse_alignment``,
``align_prediction``, the ``DepthMap`` / ``Alignment`` /
``frame_align_lstsq`` framework; rtol 1e-6), TAE and its reprojection
(rtol 1e-6), ``CsvSaver``'s file byte for byte, and ``evaluate_dataset``
with a fake pipeline (the CSV equal but for the run-stats row).  Maps hold
zeros in both prediction and ground truth, and sparse masks."""

import csv

import numpy as np
import pytest
import torch

from tests.torch_port_helpers import one_torch_thread  # noqa: F401
from video_depth_anything_torch.evals import align as t_align
from video_depth_anything_torch.evals import evaluate as t_evaluate
from video_depth_anything_torch.evals import metrics as t_metrics
from video_depth_anything_torch.evals import tae as t_tae
from video_depth_anything_tpu.evals import align as j_align
from video_depth_anything_tpu.evals import evaluate as j_evaluate
from video_depth_anything_tpu.evals import metrics as j_metrics
from video_depth_anything_tpu.evals import tae as j_tae

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL = 1e-6  # numpy code on both sides: the same float64 / float32 operations
TORCH_RTOL = 1e-5  # masked fp32 where-sums, the JAX backend's own bound (tests/test_eval.py)


def maps(seed, shape=(4, 20, 30), zeros=0.1):
    rng = np.random.RandomState(seed)
    pred = rng.rand(*shape).astype(np.float32) * 10 + 0.5
    gt = rng.rand(*shape).astype(np.float32) * 10 + 0.5
    pred[rng.rand(*shape) < zeros] = 0.0
    gt[rng.rand(*shape) < zeros] = 0.0
    valid = rng.rand(*shape) > 0.3
    return pred, gt, valid


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("masked", [True, False])
def test_metrics_match_jax(seed, masked):
    pred, gt, valid = maps(seed)
    v = valid & (gt > 0) if masked else None
    got, want = t_metrics.compute_all(pred, gt, v), j_metrics.compute_all(pred, gt, v)
    assert list(got) == list(want) == j_metrics.HEADER[4:-1]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
    for fn in ("abs_diff", "abs_rel", "signed_rel", "mse"):
        np.testing.assert_allclose(getattr(t_metrics, fn)(pred, gt, v),
                                   getattr(j_metrics, fn)(pred, gt, v), rtol=RTOL, err_msg=fn)
    for thr in (1.1, 1.25**2):
        np.testing.assert_allclose(t_metrics.delta_metric(pred, gt, thr, v),
                                   j_metrics.delta_metric(pred, gt, thr, v), rtol=RTOL)
    assert t_metrics.HEADER == j_metrics.HEADER


@pytest.mark.parametrize("masked", [True, False])
def test_compute_all_torch_matches_jax(masked):
    pred, gt, valid = maps(2)
    v = valid if masked else None
    want = {k: float(x) for k, x in j_metrics.compute_all_jax(pred, gt, v).items()}
    got = t_metrics.compute_all_torch(torch.from_numpy(pred), torch.from_numpy(gt),
                                      None if v is None else torch.from_numpy(v))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].dim() == 0
        np.testing.assert_allclose(float(got[k]), want[k], rtol=TORCH_RTOL, err_msg=k)
    # numpy inputs land on the CPU; every pixel of a zero pair counts as an outlier
    np.testing.assert_allclose(float(t_metrics.compute_all_torch(pred, gt, v)["Delta1"]),
                               want["Delta1"], rtol=TORCH_RTOL)
    # where both are positive the numpy metrics agree with the where-sums
    pos = valid & (gt > 0) & (pred > 0)
    np.testing.assert_allclose(float(t_metrics.compute_all_torch(pred, gt, pos)["AbsoluteRelative"]),
                               t_metrics.compute_all(pred, gt, pos)["AbsoluteRelative"],
                               rtol=TORCH_RTOL)


def test_alignment_matches_jax():
    rng = np.random.RandomState(4)
    gt = rng.rand(3, 24, 32).astype(np.float32) * 20 + 1.0
    gt[rng.rand(*gt.shape) < 0.1] = 0.0  # 1/gt = inf: excluded from the fit
    valid = rng.rand(3, 24, 32) > 0.2
    pred = (1.0 / np.maximum(gt, 1.0)) * 2.3 + 0.4 + rng.randn(3, 24, 32).astype(np.float32) * 0.01
    pred[rng.rand(*gt.shape) < 0.05] = 0.0
    np.testing.assert_allclose(t_align.fit_inverse_alignment(pred, gt, valid),
                               j_align.fit_inverse_alignment(pred, gt, valid), rtol=RTOL)
    for max_depth in (80.0, 5.0):
        got, want = (m.align_prediction(pred, gt, valid, max_depth) for m in (t_align, j_align))
        np.testing.assert_allclose(got[0], want[0], rtol=RTOL)
        np.testing.assert_allclose(got[1:], want[1:], rtol=RTOL)
    # a constant prediction: a rank-deficient fit
    flat = np.ones_like(pred)
    assert t_align.fit_inverse_alignment(flat, gt, valid) == \
        j_align.fit_inverse_alignment(flat, gt, valid)


@pytest.mark.parametrize("case", ["inverse_vs_metric", "pure_scale", "both_inverse",
                                  "constant_prediction"])
def test_depthmap_framework_matches_jax(case):
    rng = np.random.default_rng(6)
    gt = rng.uniform(0.5, 60.0, (12, 9))
    valid = rng.random((12, 9)) > 0.3
    results = []
    for mod in (t_align, j_align):
        if case == "inverse_vs_metric":
            pred = mod.DepthMap(0.7 / gt + 0.1, inverse=True, value_range=(0.05, 2.0))
            ref = mod.DepthMap(gt, inverse=False, valid=valid, scale=1.0, shift=0.0,
                               value_range=(0.5, 60.0))
        elif case == "pure_scale":
            pred = mod.DepthMap(2.5 * gt, inverse=False, shift=0.0)
            ref = mod.DepthMap(gt, inverse=False, valid=valid, scale=1.0, shift=0.0)
        elif case == "both_inverse":
            pred = mod.DepthMap(3.0 / gt - 0.2, inverse=True, valid=valid)
            ref = mod.DepthMap(1.0 / gt, inverse=True, scale=2.0, shift=0.0)
        else:
            pred = mod.DepthMap(np.ones_like(gt), inverse=True)
            ref = mod.DepthMap(gt, inverse=False, scale=1.0, shift=0.0)
        al = mod.frame_align_lstsq(pred, ref)
        out = [al.inverse, al.scale, al.shift, al.metric_scale, al.metric_shift]
        if np.isfinite(al.scale):
            applied = al.apply(pred)
            out += [applied.values, applied.mask(), applied.value_range, applied.is_metric()]
            if applied.is_metric():
                out.append(applied.metric_depth())
            out += [None if d is None else d.values for d in al.apply_all([pred, None, ref])]
        inv = ref.invert()
        out += [inv.values, inv.mask(), inv.value_range, inv.scale, inv.shift, inv.inverse]
        results.append(out)
    for a, b in zip(*results):
        if isinstance(a, np.ndarray) and a.dtype == bool:
            np.testing.assert_array_equal(a, b)
        elif isinstance(a, (np.ndarray, tuple)):
            np.testing.assert_allclose(a, b, rtol=RTOL)
        elif isinstance(a, float) and np.isfinite(a):
            np.testing.assert_allclose(a, b, rtol=RTOL)
        else:
            assert a == b
    for mod in (t_align, j_align):
        with pytest.raises(ValueError, match="shift"):
            mod.DepthMap(gt, inverse=True, shift=1.0).invert()
        with pytest.raises(ValueError, match="metric"):
            mod.DepthMap(gt, inverse=False).metric_depth()


def test_tae_matches_jax():
    rng = np.random.RandomState(8)
    t_len, h, w = 5, 18, 24
    depths = rng.uniform(2.0, 9.0, (t_len, h, w)).astype(np.float32)
    depths[rng.rand(t_len, h, w) < 0.1] = 0.0
    valid = rng.rand(t_len, h, w) > 0.25
    ks = np.stack([np.array([[30.0 + t, 0, 12.0], [0, 29.0, 9.0 + 0.1 * t], [0, 0, 1]])
                   for t in range(t_len)])
    extr = np.tile(np.eye(4), (t_len, 1, 1))
    for t in range(t_len):
        a = 0.03 * t
        extr[t, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        extr[t, :3, 3] = [-0.1 * t, 0.02 * t, 0.05 * t]
    rel = extr[1] @ np.linalg.inv(extr[0])
    for kw in ({}, {"intrinsics_dst": ks[1]}, {"out_shape": (h + 4, w - 3)}):
        got, want = (m.reproject_depth(depths[0], ks[0], rel, **kw) for m in (t_tae, j_tae))
        assert got.dtype == want.dtype == np.float32 and (got > 0).mean() > 0.5
        np.testing.assert_allclose(got, want, rtol=RTOL)
    for v in (valid, None):
        got = t_tae.temporal_alignment_error(depths, ks, extr, v)
        want = j_tae.temporal_alignment_error(depths, ks, extr, v)
        assert got > 0
        np.testing.assert_allclose(got, want, rtol=RTOL)
    assert t_tae.temporal_alignment_error(depths[:1], ks[:1], extr[:1]) == 0.0


METRICS = dict(Delta1=0.9, Delta2=0.95, Delta3=0.99, SignedRelative=0.01, AbsoluteError=0.5,
               AbsoluteRelative=0.05, MeanSquaredError=0.3)


def test_csv_saver_matches_jax_byte_for_byte(tmp_path):
    def fill(mod, path, extra):
        saver = mod.CsvSaver(path)
        saver.add_scene("s0", METRICS, 2.0, 0.1, n_frames=10, tae=0.02)
        saver.add_scene("s,1", {k: v * 1.5 for k, v in METRICS.items()}, 2.1, -0.2)
        saver.add_scene("s2", METRICS, np.float64(1.7), np.float32(0.3), n_frames=3, tae=None)
        saver.summarize(*extra)

    for i, extra in enumerate(((["fps"], [10.0]), ())):
        paths = [str(tmp_path / f"{tag}{i}" / "m.csv") for tag in "tj"]
        fill(t_metrics, paths[0], extra)
        fill(j_metrics, paths[1], extra)
        text = open(paths[0], "rb").read()
        assert text == open(paths[1], "rb").read()
        assert b"Overall Mean" in text and b"NotSaved" in text
        for mod, path in zip((t_metrics, j_metrics), paths):
            with pytest.raises(FileExistsError):
                mod.CsvSaver(path).add_scene("s3", METRICS, 1.0, 0.0)
    # no scene at all: a header and the summary rows
    for tag, mod in (("te", t_metrics), ("je", j_metrics)):
        mod.CsvSaver(str(tmp_path / tag / "m.csv")).summarize()
    assert (tmp_path / "te" / "m.csv").read_bytes() == (tmp_path / "je" / "m.csv").read_bytes()


class FakeDataset:
    """As ``tests/test_eval.py::test_evaluate_dataset_end_to_end``, with
    cameras that move, float images and a short third scene."""

    max_depth = 50.0

    def __len__(self):
        return 3

    def __getitem__(self, i):
        rng = np.random.RandomState(i)
        n = 2 if i == 2 else 5
        gt = rng.rand(n, 18, 24).astype(np.float32) * 10 + 1
        extr = np.tile(np.eye(4), (n, 1, 1))
        extr[:, 0, 3] = -0.05 * np.arange(n)
        return {
            "image": rng.rand(n, 18, 24, 3).astype(np.float32),
            "depth": gt,
            "valid_depth": rng.rand(n, 18, 24) > 0.2,
            "intrinsics": np.tile(np.array([[20.0, 0, 12], [0, 20.0, 9], [0, 0, 1]]), (n, 1, 1)),
            "extrinsics": extr,
            "name": f"scene{i}",
            "_gt": gt,
        }


class FakePipeline:
    """A noisy affine map of inverse GT; ``tail`` frames only (as a
    streaming pipeline), none for scenes shorter than ``tail``."""

    def __init__(self, ds, tail=None):
        self.ds, self.tail, self._i = ds, tail, 0

    def infer_video_depth(self, frames, *a, **k):
        assert frames.dtype == np.uint8
        gt = self.ds[self._i]["_gt"][: len(frames)]
        self._i += 1
        rng = np.random.RandomState(self._i)
        pred = 1.0 / gt * 3.0 + 0.2 + rng.randn(*gt.shape).astype(np.float32) * 1e-3
        if self.tail is not None:
            pred = pred[self.tail - 1:]
        return pred, -1


def read_rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.mark.parametrize("kw", [{}, {"align_only_first_frame": True},
                                {"max_frames_per_scene": 4, "compute_tae": False},
                                {"tail": 3}, {"max_scenes": 1}])
def test_evaluate_dataset_matches_jax(tmp_path, kw):
    kw = dict(kw)
    tail = kw.pop("tail", None)
    ds = FakeDataset()
    got = t_evaluate.evaluate_dataset(FakePipeline(ds, tail), ds, str(tmp_path / "t.csv"),
                                      progress=True, **kw)
    want = j_evaluate.evaluate_dataset(FakePipeline(ds, tail), ds, str(tmp_path / "j.csv"),
                                       progress=False, **kw)
    rows_t, rows_j = read_rows(got["csv"]), read_rows(want["csv"])
    # the last row holds total_frames, wall_s, fps and host_rss_mb
    assert rows_t[:-1] == rows_j[:-1] and rows_t[-1][0] == rows_j[-1][0]
    assert rows_t[-2] == ["total_frames", "wall_s", "fps", "host_rss_mb"]
    for k in ("scenes", "frames", "mean_absrel", "csv"):
        assert (got[k] == want[k]) if k != "csv" else got[k].endswith("t.csv")
    assert got["device_memory"] == {} and got["mean_absrel"] < 1e-2
    if tail:  # the short scene predicts nothing and is skipped
        assert [r[0] for r in rows_t[1:3]] == ["scene0", "scene1"] and rows_t[3] == []
