"""The port's data pipeline against the JAX package's on the same seeds:
the PointOdyssey loader on a synthesised tree (the other seven loaders:
``tests/test_torch_datasets.py``), ``augment_clip``,
``ClipSampler`` (with and without augmentation) and ``Prefetcher``.  The
copies are numpy code, so the arrays must be equal."""

import numpy as np
import pytest

import chip_smoke
from video_depth_anything_torch import data as t_data
from video_depth_anything_torch.data import augment as t_augment
from video_depth_anything_torch.data import clips as t_clips
from video_depth_anything_tpu import data as j_data
from video_depth_anything_tpu.data import augment as j_augment
from video_depth_anything_tpu.data import clips as j_clips
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def po_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pointodyssey"))
    chip_smoke.write_pointodyssey(root, scenes=2, frames=7, h=36, w=64)
    return root


def test_pointodyssey_loader_matches_jax(po_root):
    got, want = t_data.get_dataset("pointodyssey", po_root), j_data.get_dataset("pointodyssey", po_root)
    assert len(got) == len(want) == 2
    for i in range(2):
        a, b = got[i], want[i]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    # the writer's depth survives the 16-bit round trip to within one step
    assert 0.9 < float(got[0]["depth"].min()) and float(got[0]["depth"].max()) < 5.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augment_clip_matches_jax(seed):
    rng = np.random.RandomState(100 + seed)
    rgb = rng.randint(0, 256, (3, 24, 32, 3)).astype(np.uint8)
    depth = rng.rand(3, 24, 32).astype(np.float32) * 10
    valid = rng.rand(3, 24, 32) > 0.2
    k = np.tile(np.eye(3, dtype=np.float32) * 30, (3, 1, 1))
    got = t_augment.augment_clip(rgb, depth, valid, np.random.RandomState(seed),
                                 t_augment.AugmentConfig(), k)
    want = j_augment.augment_clip(rgb, depth, valid, np.random.RandomState(seed),
                                  j_augment.AugmentConfig(), k)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("augment", [False, True])
def test_clip_sampler_matches_jax(po_root, augment):
    kw = dict(clip_len=4, batch_size=2, input_size=28, seed=5)
    got = t_clips.ClipSampler([t_data.get_dataset("pointodyssey", po_root)],
                              augment=t_augment.AugmentConfig() if augment else None, **kw)
    want = j_clips.ClipSampler([j_data.get_dataset("pointodyssey", po_root)],
                               augment=j_augment.AugmentConfig() if augment else None, **kw)
    for a, b in zip((next(iter(got)) for _ in range(2)), (next(iter(want)) for _ in range(2))):
        assert a.keys() == b.keys() == {"frames", "disparity", "mask"}
        assert a["frames"].shape == (2, 4, 28, 28, 3)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_prefetcher_matches_jax():
    def boom():
        yield from range(5)
        raise RuntimeError("decode failed")

    for mod in (t_clips, j_clips):
        pf = mod.Prefetcher(boom(), depth=2)
        assert [next(pf) for _ in range(5)] == list(range(5))
        with pytest.raises(RuntimeError, match="decode failed"):
            next(pf)
        assert list(mod.Prefetcher(iter(range(7)), depth=3)) == list(range(7))


def test_prefetcher_close_stops_the_producer():
    made = []

    def endless():
        while True:
            made.append(len(made))
            yield made[-1]

    with t_clips.Prefetcher(endless(), depth=2) as pf:
        assert [next(pf) for _ in range(3)] == [0, 1, 2]
    assert not pf._thread.is_alive()
    count = len(made)
    with pytest.raises(StopIteration):
        next(pf)
    assert len(made) == count
