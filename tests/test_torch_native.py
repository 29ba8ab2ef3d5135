"""The port's native host libraries (``io/native_build.py``,
``io/native_preproc.py``, ``io/native_video.py``) and their dispatch: built
from ``native/*.cpp`` into ``_build/`` (never the committed ``native/*.so``),
the preprocessing within 2e-3 of the cv2 path and of JAX's native binding,
the window gather bit for bit, the decoder's pixels those of the cv2 path
and of JAX's ``read_video_frames`` in JAX's four cases, the cv2 path at
widths that are not multiples of 16 (where the library's pixels are wrong:
``io/native_video.py``), the path that ran visible, and the cv2 fallback
when the library cannot be built.

``tests/conftest.py`` pins ``VDA_NATIVE_PREPROC=0`` suite-wide, so every
test here sets both switches itself.  The preprocessing library runs its
OpenMP loops on one thread here (``omp_set_num_threads(1)`` on the calling
thread): the test workers share the cores."""

import hashlib
import os

import numpy as np
import pytest

from tests.torch_port_helpers import one_torch_thread  # noqa: F401
from video_depth_anything_torch.io import native_build, native_preproc, native_video
from video_depth_anything_torch.io import video as tvideo
from video_depth_anything_torch.utils import transform as ttransform

pytestmark = pytest.mark.usefixtures("one_torch_thread", "one_omp_thread")

# JAX's own bound of its native path against cv2 (tests/test_native_preproc.py:20-24):
# the same bicubic taps, summed in another order.
PREPROC_TOL = 2e-3
# The port's build and JAX's committed one compile the same source; only the
# compiler's vectorisation (-march=native on two hosts) may reorder the sums.
SAME_SOURCE_TOL = 1e-5
CASES = [(12, -1, -1), (8, 10, -1), (6, -1, 60), (5, 8, 50)]  # JAX test_native_decode.py


@pytest.fixture(scope="module")
def one_omp_thread():
    lib = native_build.load("preproc")
    if lib is not None and hasattr(lib, "omp_set_num_threads"):  # an OpenMP build
        lib.omp_set_num_threads(1)
    yield


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("native") / "clip.mp4")
    rng = np.random.RandomState(4)
    yy, xx = np.mgrid[0:64, 0:96]
    frames = np.stack([np.stack([(xx * 3 + 7 * i) % 256, (yy * 4 + 5 * i) % 256,
                                 rng.randint(0, 256, (64, 96))], -1) for i in range(20)])
    tvideo.save_video(frames.astype(np.uint8), path, fps=24)
    return path


def test_libraries_build_from_source_into_build_dir():
    status = native_build.status()
    for name in ("preproc", "decode"):
        lib = native_build.load(name)
        assert lib is not None, status[name]
        path = lib._name
        assert os.path.dirname(path) == str(native_build.BUILD_DIR)
        assert "native" + os.sep not in os.path.relpath(path, native_build.NATIVE_DIR.parent)
        assert os.path.basename(path) != f"libvda_{name}.so"


def test_build_writes_nothing_under_native(tmp_path, monkeypatch):
    """A fresh build (another build directory) leaves ``native/`` as it was."""
    def snapshot():
        return {p: hashlib.sha256(open(native_build.NATIVE_DIR / p, "rb").read()).hexdigest()
                for p in sorted(os.listdir(native_build.NATIVE_DIR))}

    before = snapshot()
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native_build, "_libs", {})
    monkeypatch.setattr(native_build, "_status", {})
    assert native_build.load("preproc") is not None
    assert os.listdir(tmp_path / "_build") == [native_build.lib_path("preproc", native_build._cxx()).name]
    assert snapshot() == before


def test_builds_without_openmp_where_the_compiler_has_none(tmp_path, monkeypatch):
    """A compiler without an OpenMP runtime (no ``libgomp.spec``) builds the
    source without ``-fopenmp``; the status says so, and the sequential
    loops give the OpenMP build's output bit for bit."""
    frames = (np.random.RandomState(9).rand(3, 50, 90, 3) * 255).astype(np.uint8)
    want = native_preproc.preprocess_frames_native(frames, 28)
    real = native_build._compile

    def no_openmp(name, cxx, flags):
        if "-fopenmp" in flags:
            raise RuntimeError(f"g++ failed for native/{name}.cpp: g++: fatal error: cannot "
                               "read spec file 'libgomp.spec': No such file or directory")
        return real(name, cxx, flags)

    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native_build, "_libs", {})
    monkeypatch.setattr(native_build, "_status", {})
    monkeypatch.setattr(native_build, "_compile", no_openmp)
    monkeypatch.setattr(native_preproc, "_typed", False)
    assert native_preproc.available()
    note = native_build.status()["preproc"]
    assert "without -fopenmp" in note and "libgomp.spec" in note
    assert not hasattr(native_build.load("preproc"), "omp_set_num_threads")
    np.testing.assert_array_equal(native_preproc.preprocess_frames_native(frames, 28), want)


def test_library_name_keys_source_flags_and_host(monkeypatch):
    cxx = native_build._cxx()
    a = native_build.lib_path("preproc", cxx)
    b = native_build.lib_path("preproc", cxx, native_build.CXXFLAGS[:-1])
    monkeypatch.setattr(native_build, "_host_cpu", lambda: "another host")
    c = native_build.lib_path("preproc", cxx)
    assert len({a, b, c}) == 3


@pytest.mark.parametrize("size,shape", [(70, (4, 120, 160, 3)), (28, (3, 50, 90, 3))])
def test_native_preprocessing_matches_cv2(size, shape, monkeypatch):
    frames = (np.random.RandomState(size).rand(*shape) * 255).astype(np.uint8)
    monkeypatch.setenv("VDA_NATIVE_PREPROC", "0")
    want = ttransform.preprocess_frames(frames, size)
    assert ttransform.last_preprocessor() == "cv2"
    monkeypatch.setenv("VDA_NATIVE_PREPROC", "1")
    got = ttransform.preprocess_frames(frames, size)
    assert ttransform.last_preprocessor() == "native"
    assert got.shape == want.shape
    assert np.abs(got - want).max() < PREPROC_TOL
    np.testing.assert_array_equal(got, native_preproc.preprocess_frames_native(frames, size))


def test_native_preprocessing_matches_jax():
    from video_depth_anything_tpu.io.native_preproc import available, preprocess_frames_native

    if not available():
        pytest.skip("the JAX package's native library does not load on this host")
    frames = (np.random.RandomState(5).rand(4, 120, 160, 3) * 255).astype(np.uint8)
    want = preprocess_frames_native(frames, 70)
    got = native_preproc.preprocess_frames_native(frames, 70, (56, 70))
    assert np.abs(native_preproc.preprocess_frames_native(frames, 70) - want).max() < SAME_SOURCE_TOL
    assert got.shape == (4, 56, 70, 3)
    np.testing.assert_allclose(got, preprocess_frames_native(frames, 70, (56, 70)), rtol=0,
                               atol=SAME_SOURCE_TOL)


def test_native_gather_is_bit_for_bit():
    from video_depth_anything_tpu.io.native_preproc import gather_windows_native

    pre = np.random.RandomState(6).rand(6, 8, 9, 3).astype(np.float32)
    idx = np.array([[0, 5, 2, 2], [3, 3, 1, 0]], np.int64)
    got = native_preproc.gather_windows_native(pre, idx)
    np.testing.assert_array_equal(got, pre[idx])
    np.testing.assert_array_equal(got, gather_windows_native(pre, idx))


def test_data_parallel_gather_dispatch(monkeypatch):
    """The data-parallel pipeline gathers its window batches natively unless
    ``VDA_NATIVE_PREPROC=0`` (JAX ``parallel/data_parallel.py:110-128``)."""
    from video_depth_anything_torch.parallel.data_parallel import DataParallelVideoDepthPipeline

    pipe = DataParallelVideoDepthPipeline.__new__(DataParallelVideoDepthPipeline)
    pre = np.random.RandomState(7).rand(40, 4, 5, 3).astype(np.float32)
    idx = np.stack([np.arange(32), np.arange(8, 40)])
    for env, path in (("1", "native"), ("0", "numpy")):
        monkeypatch.setenv("VDA_NATIVE_PREPROC", env)
        np.testing.assert_array_equal(pipe._gather(pre, idx), pre[idx])
        assert pipe.gather_path == path


@pytest.mark.parametrize("case", CASES)
def test_native_decode_matches_cv2_and_jax(clip, case, monkeypatch):
    from video_depth_anything_tpu.io.video import read_video_frames as jax_read

    monkeypatch.setenv("VDA_NATIVE_DECODE", "1")
    got, fps = tvideo.read_video_frames(clip, *case)
    assert tvideo.last_decoder() == "native"
    np.testing.assert_array_equal(got, native_video.read_video_frames_native(clip, *case)[0])
    jax_frames, jax_fps = jax_read(clip, *case)
    monkeypatch.setenv("VDA_NATIVE_DECODE", "0")
    want, want_fps = tvideo.read_video_frames(clip, *case)
    assert tvideo.last_decoder() == "cv2"
    assert fps == want_fps == jax_fps
    assert got.shape == want.shape and got.shape[0] == case[0]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_frames)


def test_unaligned_widths_decode_with_cv2(tmp_path, monkeypatch):
    """At the DAVIS width (854 = 53 * 16 + 6) the library leaves values
    that are not the frame's in the last 6 columns of every row (what they
    are depends on the heap: JAX's binding of the same source returned 72-74
    where cv2 gives 250 on a 480x854 clip of ``chip_smoke.clip_frames``), and at widths of 8 mod 16 it writes
    past its buffer and kills the process.  The port's binding refuses such
    widths, so the pixels are cv2's."""
    import chip_smoke

    path = str(tmp_path / "davis.mp4")
    tvideo.save_video(chip_smoke.clip_frames(64, 854, 4), path, fps=24)
    assert native_video.read_video_frames_native(path, 3) is None
    monkeypatch.setenv("VDA_NATIVE_DECODE", "1")
    got, _ = tvideo.read_video_frames(path, 3)
    assert tvideo.last_decoder() == "cv2"
    monkeypatch.setenv("VDA_NATIVE_DECODE", "0")
    np.testing.assert_array_equal(got, tvideo.read_video_frames(path, 3)[0])


def test_falls_back_to_cv2_when_the_build_fails(clip, monkeypatch):
    monkeypatch.setattr(native_build, "_libs", {})
    monkeypatch.setattr(native_build, "_status", {})
    monkeypatch.setenv("CXX", "no-such-compiler")
    monkeypatch.setattr(native_preproc, "_typed", False)
    monkeypatch.setattr(native_video, "_typed", False)
    assert not native_preproc.available() and not native_video.available()
    assert native_build.status()["decode"].startswith("not built: no C++ compiler")
    monkeypatch.setenv("VDA_NATIVE_DECODE", "1")
    monkeypatch.setenv("VDA_NATIVE_PREPROC", "1")
    frames, _ = tvideo.read_video_frames(clip, 4)
    assert tvideo.last_decoder() == "cv2"
    ttransform.preprocess_frames(frames, 28)
    assert ttransform.last_preprocessor() == "cv2"


def test_unopenable_container_falls_back(tmp_path, monkeypatch):
    bad = tmp_path / "not_a_video.mp4"
    bad.write_bytes(b"no video here")
    assert native_video.read_video_frames_native(str(bad)) is None
    monkeypatch.setenv("VDA_NATIVE_DECODE", "1")
    with pytest.raises((FileNotFoundError, ValueError)):
        tvideo.read_video_frames(str(bad))
    assert tvideo.last_decoder() == "cv2"


def test_cli_prints_the_host_paths(clip, tmp_path, monkeypatch, capsys):
    from video_depth_anything_torch import run

    for env, path in (("1", "native"), ("0", "cv2")):
        monkeypatch.setenv("VDA_NATIVE_DECODE", env)
        monkeypatch.setenv("VDA_NATIVE_PREPROC", env)
        assert run.main(["--input_video", clip, "--output_dir", str(tmp_path), "--random_init",
                         "--device", "cpu", "--fp32", "--input_size", "28", "--max_len",
                         "6"]) == 0
        out = capsys.readouterr().out
        assert f'host paths: {{"decode": "{path}", "preprocess": "{path}"}}' in out
