"""The port's seven other scene loaders against the JAX package's on
synthetic trees in each dataset's on-disk layout: ``get_dataset`` of both
packages must give the same scenes in the same order, every key of every
sample equal bit for bit (the loaders are numpy code).  Also every format
reader and writer on seeded data, IRS's gated EXR error and IRS through
one stand-in EXR reader patched into both packages, ``ClipSampler`` over a
mixed KITTI + DynamicReplica set under one seed, two training steps of
``python -m video_depth_anything_torch.train`` on that pair, and
``data/visualize.py`` (the back-projection, the GIF's and the point-cloud
plot's pixels)."""

import gzip
import json
import os

import cv2
import numpy as np
import pytest
from PIL import Image, ImageSequence

import chip_smoke
from tests.torch_port_helpers import one_torch_thread  # noqa: F401
from video_depth_anything_torch import data as t_data
from video_depth_anything_torch.data import clips as t_clips
from video_depth_anything_torch.data import dynamicreplica as t_dr
from video_depth_anything_torch.data import irs as t_irs
from video_depth_anything_torch.data import kitti as t_kitti
from video_depth_anything_torch.data import sceneflow as t_sf
from video_depth_anything_torch.data import sintel as t_sintel
from video_depth_anything_torch.data import tartanair as t_ta
from video_depth_anything_torch.data import vkitti as t_vk
from video_depth_anything_tpu import data as j_data
from video_depth_anything_tpu.data import clips as j_clips
from video_depth_anything_tpu.data import dynamicreplica as j_dr
from video_depth_anything_tpu.data import irs as j_irs
from video_depth_anything_tpu.data import kitti as j_kitti
from video_depth_anything_tpu.data import sceneflow as j_sf
from video_depth_anything_tpu.data import sintel as j_sintel
from video_depth_anything_tpu.data import tartanair as j_ta
from video_depth_anything_tpu.data import vkitti as j_vk

pytestmark = pytest.mark.usefixtures("one_torch_thread")

H, W = 12, 20


def _rgb(path, rng, h=H, w=W):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    cv2.imwrite(path, rng.randint(0, 256, (h, w, 3)).astype(np.uint8))


def _depth(rng, lo=0.5, hi=60.0, zeros=0.2, h=H, w=W):
    """Seeded metric depth with a share of zero (invalid) pixels."""
    d = rng.uniform(lo, hi, (h, w)).astype(np.float32)
    return np.where(rng.rand(h, w) < zeros, 0.0, d).astype(np.float32)


def write_vkitti(root, rng, frames=3):
    for scene in ("Scene01", "Scene02"):
        for cond in ("clone", "fog"):
            base = os.path.join(root, scene, cond)
            for cam in ("0", "1"):
                for i in range(frames):
                    _rgb(os.path.join(base, "frames/rgb", f"Camera_{cam}", f"rgb_{i:05d}.jpg"),
                         rng)
                    d = os.path.join(base, "frames/depth", f"Camera_{cam}")
                    os.makedirs(d, exist_ok=True)
                    cv2.imwrite(os.path.join(d, f"depth_{i:05d}.png"),
                                np.round(_depth(rng, 1.0, 700.0) * 100).astype(np.uint16))
            with open(os.path.join(base, "intrinsic.txt"), "w") as f:
                f.write("frame cameraID K[0,0] K[1,1] K[0,2] K[1,2]\n")
                for i in range(frames):
                    for cam in ("0", "1"):
                        k = rng.uniform(100, 900, 4)
                        f.write(f"{i} {cam} " + " ".join(f"{x:.6f}" for x in k) + "\n")
            with open(os.path.join(base, "extrinsic.txt"), "w") as f:
                f.write("frame cameraID r1,1 r1,2 r1,3 t1 r2,1 r2,2 r2,3 t2 r3,1 r3,2 r3,3 t3 "
                        "0 0 0 1\n")
                for i in range(frames):
                    for cam in ("0", "1"):
                        v = rng.standard_normal(12)
                        f.write(f"{i} {cam} " + " ".join(f"{x:.6f}" for x in v) + " 0 0 0 1\n")


def write_tartanair(root, rng, frames=3):
    for env, setting, traj in (("abandonedfactory", "Easy", "P001"),
                               ("abandonedfactory", "Hard", "P002"), ("office", "Easy", "P000")):
        scene = os.path.join(root, env, setting, traj)
        for cam in ("left", "right"):
            os.makedirs(os.path.join(scene, f"depth_{cam}"))
            for i in range(frames):
                _rgb(os.path.join(scene, f"image_{cam}", f"{i:06d}_{cam}.png"), rng)
                # sky beyond the 800 m clip
                np.save(os.path.join(scene, f"depth_{cam}", f"{i:06d}_{cam}_depth.npy"),
                        _depth(rng, 0.5, 2000.0))
            q = rng.standard_normal((frames, 4))
            q /= np.linalg.norm(q, axis=1, keepdims=True)
            poses = np.concatenate([rng.standard_normal((frames, 3)), q], axis=1)
            np.savetxt(os.path.join(scene, f"pose_{cam}.txt"), poses)


def write_dynamicreplica(root, rng, frames=3, split="train", size=(H, W)):
    split_dir = os.path.join(root, split)
    annots = []
    for seq, fmt in (("seqA", "ndc_norm_image_bounds"), ("seqB", "ndc_isotropic")):
        for cam in ("left", "right"):
            for i in range(frames):
                stem = f"{seq}_{cam}_{i:04d}.png"
                _rgb(os.path.join(split_dir, "images", stem), rng, *size)
                os.makedirs(os.path.join(split_dir, "depths"), exist_ok=True)
                d16 = _depth(rng, 0.1, 30.0, h=size[0], w=size[1]).astype(np.float16)
                Image.fromarray(d16.view(np.uint16)).save(os.path.join(split_dir, "depths", stem))
                os.makedirs(os.path.join(split_dir, "masks"), exist_ok=True)
                cv2.imwrite(os.path.join(split_dir, "masks", stem),
                            (rng.rand(*size, 3) > 0.4).astype(np.uint8) * 255)
                annots.append({
                    "sequence_name": seq, "camera_name": cam,
                    "image": {"path": f"images/{stem}", "size": list(size)},
                    "depth": {"path": f"depths/{stem}", "scale_adjustment": 1.0,
                              "mask_path": f"masks/{stem}"},
                    "viewpoint": {
                        "principal_point": rng.uniform(-0.2, 0.2, 2).tolist(),
                        "focal_length": rng.uniform(1.0, 3.0, 2).tolist(),
                        "intrinsics_format": fmt,
                        "R": np.linalg.qr(rng.standard_normal((3, 3)))[0].tolist(),
                        "T": rng.standard_normal(3).tolist(),
                    },
                })
    with gzip.open(os.path.join(split_dir, f"frame_annotations_{split}.jgz"), "wt",
                   encoding="utf8") as z:
        json.dump(annots, z)


def write_sceneflow(root, rng, frames=3):
    """FlyingThings3D TRAIN and TEST (frame numbers from 6), Driving at 15
    and 35 mm and Monkaa (from 1)."""
    scenes = [("TRAIN/A/0000", 6), ("TRAIN/B/0001", 6), ("TEST/A/0002", 6),
              ("15mm_focallength/scene_forwards", 1), ("35mm_focallength/scene_backwards", 1),
              ("a_rain_of_stones_x2", 1)]
    for scene, first in scenes:
        sub = scene + "/slow" if "focallength" in scene else scene
        for side in ("left", "right"):
            for i in range(first, first + frames):
                _rgb(os.path.join(root, "frames_cleanpass", sub, side, f"{i:04d}.png"), rng)
                d = os.path.join(root, "disparity", sub, side)
                os.makedirs(d, exist_ok=True)
                disp = np.where(rng.rand(H, W) < 0.1, 0.0, rng.uniform(0.5, 90.0, (H, W)))
                t_sf.write_pfm(os.path.join(d, f"{i:04d}.pfm"), disp.astype(np.float32))
        os.makedirs(os.path.join(root, "camera_data", sub), exist_ok=True)
        with open(os.path.join(root, "camera_data", sub, "camera_data.txt"), "w") as f:
            for i in range(first, first + frames):
                f.write(f"Frame {i}\n")
                for cam in ("L", "R"):
                    f.write(cam + " " + " ".join(f"{x:.6f}" for x in rng.standard_normal(16))
                            + "\n")
                f.write("\n")


def write_irs(root, rng, frames=3):
    for scene in ("Home_A", "Office_B"):
        for i in range(1, frames + 1):
            _rgb(os.path.join(root, scene, f"l_{i}.png"), rng)
            disp = np.where(rng.rand(H, W) < 0.1, 0.0, rng.uniform(0.1, 200.0, (H, W)))
            with open(os.path.join(root, scene, f"d_{i}.exr"), "wb") as f:
                np.save(f, disp.astype(np.float32))


def npy_exr(path):
    """Stand-in EXR reader shared by both packages: the ``.exr`` files of
    ``write_irs`` hold ``.npy`` bytes."""
    return np.load(path).astype(np.float32)


def assert_same(got, want):
    assert len(got) == len(want) > 0
    assert [s["name"] for s in got.sample_list] == [s["name"] for s in want.sample_list]
    for i in range(len(got)):
        a, b = got[i], want[i]
        assert a.keys() == b.keys()
        for k in a:
            if k == "name":
                assert a[k] == b[k]
                continue
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y, err_msg=f"{a['name']} {k}")


def tree(name, root, rng):
    if name == "kitti":
        chip_smoke.write_kitti(root, drives=2, frames=4, h=H, w=W + 20)
        chip_smoke.write_kitti(root, drives=1, frames=3, h=H, w=W + 20, split="val", seed=1)
    elif name == "vkitti":
        write_vkitti(root, rng)
    elif name == "sintel":
        chip_smoke.write_sintel(root, scenes=2, frames=11, h=H, w=W)
        chip_smoke.write_sintel(root, scenes=1, frames=3, h=H, w=W, split="test", seed=1)
    elif name == "tartanair":
        write_tartanair(root, rng)
    elif name == "dynamicreplica":
        write_dynamicreplica(root, rng)
        write_dynamicreplica(root, rng, frames=2, split="valid")
    elif name == "sceneflow":
        write_sceneflow(root, rng)
    elif name == "irs":
        write_irs(root, rng)


# every keyword the JAX loaders take, on each tree
KWARGS = {
    "kitti": [{}, {"is_val": True}, {"cameras": ("image_02",), "verbose": True}],
    "vkitti": [{}, {"cameras": ("1",), "verbose": True}],
    "sintel": [{}, {"is_test": True}],
    "tartanair": [{}, {"cameras": ("right",)}],
    "dynamicreplica": [{}, {"split": "valid"}],
    "sceneflow": [{}, {"is_test": True}, {"use_flyingthings": False, "camera": "R"},
                  {"use_driving": False, "use_monkaa": False}],
    "irs": [{}],
}


@pytest.mark.parametrize("name", list(KWARGS))
def test_loader_matches_jax(name, tmp_path, monkeypatch):
    root = str(tmp_path / name)
    os.makedirs(root)
    tree(name, root, np.random.RandomState(7))
    if name == "irs":
        monkeypatch.setattr(t_irs, "load_exr", npy_exr)
        monkeypatch.setattr(j_irs, "load_exr", npy_exr)
    for kw in KWARGS[name]:
        assert_same(t_data.get_dataset(name, root, **kw), j_data.get_dataset(name, root, **kw))


def test_get_dataset_serves_every_name(tmp_path):
    assert set(t_data.DATASETS) == {"kitti", "vkitti", "sintel", "tartanair", "pointodyssey",
                                    "dynamicreplica", "sceneflow", "irs"}
    for name in t_data.DATASETS:  # a missing root raises as in JAX, never "not ported"
        for mod in (t_data, j_data):
            with pytest.raises((FileNotFoundError, OSError)):
                mod.get_dataset(name, str(tmp_path / "absent"))
    with pytest.raises(ValueError, match="unknown dataset"):
        t_data.get_dataset("nyu", str(tmp_path))


def test_kitti_matches_depth_by_frame_index(tmp_path):
    """GT skips the first and last five frames: sample j is raw frame j + 5."""
    root = str(tmp_path)
    chip_smoke.write_kitti(root, drives=1, frames=4, h=H, w=W)
    s = t_data.get_dataset("kitti", root, cameras=("image_02",))[0]
    raw = os.path.join(root, "kitti_raw/2011_09_26/2011_09_26_drive_0001_sync/image_02/data")
    want = [cv2.imread(os.path.join(raw, f"{i:010d}.png"))[..., ::-1] / np.float32(255)
            for i in range(5, 9)]
    np.testing.assert_array_equal(s["image"], np.stack(want).astype(np.float32))
    assert s["image"].shape == (4, H, W, 3) and 0 < s["valid_depth"].mean() < 0.5


def test_irs_gated_error_matches_jax(tmp_path):
    root = str(tmp_path)
    _rgb(os.path.join(root, "Home_A", "l_1.png"), np.random.RandomState(0))
    with open(os.path.join(root, "Home_A", "d_1.exr"), "wb") as f:
        f.write(b"\x76\x2f\x31\x01")  # an EXR magic and nothing else
    errors = []
    for mod in (t_data, j_data):
        with pytest.raises(RuntimeError) as e:
            mod.get_dataset("irs", root)[0]
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "cannot decode EXR" in errors[0]


def test_format_readers_and_writers_match_jax(tmp_path):
    rng = np.random.RandomState(3)
    d = rng.standard_normal((7, 9)).astype(np.float32) * 10
    k, rt = rng.standard_normal((3, 3)), rng.standard_normal((3, 4))
    # .dpt / .cam: the same bytes, and each package reads the other's file
    t_sintel.write_dpt(str(tmp_path / "t.dpt"), d)
    j_sintel.write_dpt(str(tmp_path / "j.dpt"), d)
    t_sintel.write_cam(str(tmp_path / "t.cam"), k, rt)
    j_sintel.write_cam(str(tmp_path / "j.cam"), k, rt)
    for ext in ("dpt", "cam"):
        assert (tmp_path / f"t.{ext}").read_bytes() == (tmp_path / f"j.{ext}").read_bytes()
    np.testing.assert_array_equal(t_sintel.read_dpt(str(tmp_path / "j.dpt")), d)
    for a, b in zip(t_sintel.read_cam(str(tmp_path / "j.cam")),
                    j_sintel.read_cam(str(tmp_path / "t.cam"))):
        np.testing.assert_array_equal(a, b)
    (tmp_path / "bad.dpt").write_bytes(np.float32(1.0).tobytes() * 4)
    for mod in (t_sintel, j_sintel):
        with pytest.raises(ValueError, match="magic"):
            mod.read_dpt(str(tmp_path / "bad.dpt"))
        with pytest.raises(ValueError, match="magic"):
            mod.read_cam(str(tmp_path / "bad.dpt"))

    # PFM: little-endian grey (the writers), big-endian colour (positive scale)
    t_sf.write_pfm(str(tmp_path / "t.pfm"), d, scale=2.0)
    j_sf.write_pfm(str(tmp_path / "j.pfm"), d, scale=2.0)
    assert (tmp_path / "t.pfm").read_bytes() == (tmp_path / "j.pfm").read_bytes()
    col = rng.standard_normal((5, 6, 3)).astype(np.float32)
    with open(tmp_path / "big.pfm", "wb") as f:
        f.write(b"PF\n6 5\n3.5\n")
        np.flipud(col).astype(">f4").tofile(f)
    for name in ("t.pfm", "big.pfm"):
        got, want = t_sf.read_pfm(str(tmp_path / name)), j_sf.read_pfm(str(tmp_path / name))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    np.testing.assert_array_equal(t_sf.read_pfm(str(tmp_path / "big.pfm"))[0], col)
    (tmp_path / "bad.pfm").write_bytes(b"P6\n")
    for mod in (t_sf, j_sf):
        with pytest.raises(ValueError, match="PFM"):
            mod.read_pfm(str(tmp_path / "bad.pfm"))

    # camera_data.txt, both cameras
    with open(tmp_path / "camera_data.txt", "w") as f:
        for i in range(3):
            f.write(f"Frame {i}\n")
            for cam in "LR":
                f.write(cam + " " + " ".join(map(str, rng.standard_normal(16))) + "\n")
    for cam in "LR":
        np.testing.assert_array_equal(t_sf.read_camera_data(str(tmp_path / "camera_data.txt"), cam),
                                      j_sf.read_camera_data(str(tmp_path / "camera_data.txt"), cam))

    # float16 bits in a 16-bit PNG
    d16 = (rng.rand(7, 9) * 50).astype(np.float16)
    Image.fromarray(d16.view(np.uint16)).save(tmp_path / "d16.png")
    got = t_dr.load_float16_png_depth(str(tmp_path / "d16.png"))
    np.testing.assert_array_equal(got, j_dr.load_float16_png_depth(str(tmp_path / "d16.png")))
    np.testing.assert_array_equal(got, d16.astype(np.float32))


def test_camera_readers_match_jax(tmp_path):
    rng = np.random.RandomState(5)
    root = str(tmp_path / "kitti")
    chip_smoke.write_kitti(root, drives=1, frames=1, h=H, w=W)
    calib = os.path.join(root, "kitti_raw", "2011_09_26")
    got, want = t_kitti.read_kitti_calib(calib), j_kitti.read_kitti_calib(calib)
    assert got.keys() == want.keys() == {f"K_cam{i}" for i in range(4)}
    for key in got:
        np.testing.assert_array_equal(got[key], want[key])

    vk = str(tmp_path / "vk")
    write_vkitti(vk, rng, frames=4)
    base = os.path.join(vk, "Scene01", "fog")
    for cam in ("0", "1"):
        for fn in ("read_vkitti_intrinsics", "read_vkitti_extrinsics"):
            path = os.path.join(base, "intrinsic.txt" if "intr" in fn else "extrinsic.txt")
            a, b = getattr(t_vk, fn)(path, cam), getattr(j_vk, fn)(path, cam)
            assert a.shape[0] == 4 and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)

    ta = str(tmp_path / "ta")
    write_tartanair(ta, rng, frames=5)
    pose = os.path.join(ta, "office", "Easy", "P000", "pose_left.txt")
    got, want = t_ta.poses_to_extrinsics(pose), j_ta.poses_to_extrinsics(pose)
    assert got.shape == (5, 4, 4) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.savetxt(tmp_path / "one_pose.txt", np.loadtxt(pose)[:1])  # a single row
    np.testing.assert_array_equal(t_ta.poses_to_extrinsics(str(tmp_path / "one_pose.txt")),
                                  j_ta.poses_to_extrinsics(str(tmp_path / "one_pose.txt")))
    for q in (rng.standard_normal(4), np.array([0.0, 0.0, 0.0, 1.0]), np.zeros(4)):
        np.testing.assert_array_equal(t_ta.quat_to_rotmat(q), j_ta.quat_to_rotmat(q))
    # a unit quaternion gives a rotation
    r = t_ta.quat_to_rotmat(np.array([0.1, -0.2, 0.3, 0.9]) / np.linalg.norm([0.1, -0.2, 0.3, 0.9]))
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-12)

    for fmt in ("ndc_norm_image_bounds", "ndc_isotropic", "NDC_ISOTROPIC"):
        cam = {"principal_point": [0.1, -0.05], "focal_length": [1.7, 1.9],
               "intrinsics_format": fmt, "R": np.eye(3).tolist(), "T": [0.5, 0.0, -1.0]}
        got, want = t_dr.viewpoint_to_camera(cam, [30, 40]), j_dr.viewpoint_to_camera(cam, [30, 40])
        for key in ("intrinsics", "extrinsics"):
            np.testing.assert_array_equal(got[key], want[key])
    # image_size is (h, w): the half extents are (w/2, h/2) = (20, 15)
    np.testing.assert_allclose(got["intrinsics"][:2, 2], [20 - 0.1 * 15, 15 + 0.05 * 15])
    for mod in (t_dr, j_dr):
        with pytest.raises(ValueError, match="unknown intrinsics format"):
            mod.viewpoint_to_camera({**cam, "intrinsics_format": "screen"}, [30, 40])


@pytest.fixture(scope="module")
def mixed_roots(tmp_path_factory):
    root = tmp_path_factory.mktemp("mixed")
    kitti, dr = str(root / "kitti"), str(root / "dr")
    chip_smoke.write_kitti(kitti, drives=1, frames=5, h=24, w=80)
    write_dynamicreplica(dr, np.random.RandomState(11), frames=4, size=(36, 48))
    return kitti, dr


def test_clip_sampler_over_mixed_datasets_matches_jax(mixed_roots):
    kitti, dr = mixed_roots
    kw = dict(clip_len=3, batch_size=2, input_size=28, seed=9)
    got = t_clips.ClipSampler([t_data.get_dataset("kitti", kitti),
                               t_data.get_dataset("dynamicreplica", dr)], **kw)
    want = j_clips.ClipSampler([j_data.get_dataset("kitti", kitti),
                                j_data.get_dataset("dynamicreplica", dr)], **kw)
    it_got, it_want = iter(got), iter(want)
    for _ in range(4):
        a, b = next(it_got), next(it_want)
        assert a.keys() == b.keys() == {"frames", "disparity", "mask"}
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_train_cli_over_mixed_datasets(mixed_roots, tmp_path):
    from video_depth_anything_torch.train.__main__ import main

    kitti, dr = mixed_roots
    out = str(tmp_path / "out")
    assert main(["--dataset", "kitti", "--root", kitti, "--dataset", "dynamicreplica", "--root",
                 dr, "--device", "cpu", "--encoder", "vits", "--input_size", "28", "--clip_len",
                 "2", "--steps", "2", "--log_every", "1", "--out", out]) == 0
    lines = [json.loads(x) for x in open(os.path.join(out, "train_log.jsonl"))]
    assert [x["step"] for x in lines] == [1, 2]
    assert all(np.isfinite(x[k]) for x in lines for k in ("loss", "ssi", "tgm", "grad_norm"))


def test_dataset_visualizations_match_jax(tmp_path):
    from video_depth_anything_torch.data import visualize as t_vis
    from video_depth_anything_tpu.data import visualize as j_vis

    root = str(tmp_path / "sintel")
    chip_smoke.write_sintel(root, scenes=1, frames=3, h=H, w=W)
    sample = t_data.get_dataset("sintel", root)[0]
    rng = np.random.RandomState(2)
    for extr in (sample["extrinsics"][1], None):
        for valid in (sample["valid_depth"][1], None):
            got = t_vis.backproject_to_points(sample["depth"][1], sample["intrinsics"][1], extr,
                                              rgb=sample["image"][1], valid=valid, stride=3)
            want = j_vis.backproject_to_points(sample["depth"][1], sample["intrinsics"][1], extr,
                                               rgb=sample["image"][1], valid=valid, stride=3)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    assert t_vis.backproject_to_points(rng.rand(8, 8), np.eye(3))[1] is None
    paths = []
    for tag, mod in (("t", t_vis), ("j", j_vis)):
        paths.append(mod.save_scene_gif(sample, str(tmp_path / f"{tag}.gif"), fps=4, max_frames=2))
        paths.append(mod.plot_scene_pointcloud(sample, frame_ids=(0, 2),
                                               out_path=str(tmp_path / f"{tag}.png"), stride=4))
    for a, b in ((paths[0], paths[2]), (paths[1], paths[3])):
        frames_a, frames_b = ([np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(
            Image.open(p))] for p in (a, b))
        assert len(frames_a) == len(frames_b) == (2 if a.endswith(".gif") else 1)
        np.testing.assert_array_equal(np.stack(frames_a), np.stack(frames_b))
