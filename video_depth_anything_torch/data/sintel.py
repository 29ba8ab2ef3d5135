"""MPI Sintel depth (decode conventions of ``datasets/sintel.py``).

``.dpt`` binary depth and ``.cam`` camera files with the 202021.25 magic
float check (``sintel.py:22-54``); depth already in meters; extrinsics are
the 3×4 world→camera matrix padded to 4×4.

A copy of the JAX package's ``data/sintel.py`` (numpy host code): the same
files give the same arrays.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Dict, Tuple

import numpy as np

from video_depth_anything_torch.data.base import SceneDepthDataset, imread_rgb01, natsorted

TAG_FLOAT = 202021.25


def read_dpt(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        check = np.fromfile(f, dtype=np.float32, count=1)[0]
        if check != np.float32(TAG_FLOAT):
            raise ValueError(f"bad .dpt magic in {path}: {check}")
        width = int(np.fromfile(f, dtype=np.int32, count=1)[0])
        height = int(np.fromfile(f, dtype=np.int32, count=1)[0])
        if not (0 < width and 0 < height and width * height < 100_000_000):
            raise ValueError(f"bad .dpt size in {path}: {width}x{height}")
        return np.fromfile(f, dtype=np.float32, count=-1).reshape(height, width)


def write_dpt(path: str, depth: np.ndarray) -> None:
    """Inverse of ``read_dpt`` (used by tests/tools)."""
    h, w = depth.shape
    with open(path, "wb") as f:
        np.float32(TAG_FLOAT).tofile(f)
        np.int32(w).tofile(f)
        np.int32(h).tofile(f)
        depth.astype(np.float32).tofile(f)


def read_cam(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        check = np.fromfile(f, dtype=np.float32, count=1)[0]
        if check != np.float32(TAG_FLOAT):
            raise ValueError(f"bad .cam magic in {path}: {check}")
        m = np.fromfile(f, dtype="float64", count=9).reshape(3, 3)
        n = np.fromfile(f, dtype="float64", count=12).reshape(3, 4)
    return m, n


def write_cam(path: str, intrinsics: np.ndarray, extrinsics34: np.ndarray) -> None:
    with open(path, "wb") as f:
        np.float32(TAG_FLOAT).tofile(f)
        intrinsics.astype("float64").tofile(f)
        extrinsics34.astype("float64").tofile(f)


class Sintel(SceneDepthDataset):
    max_depth = 10_000.0
    min_depth = 0.0

    def __init__(self, root: str, is_test: bool = False):
        super().__init__(root)
        split = "test" if is_test else "training"
        base = os.path.join(root, split)
        scenes = natsorted(
            e.name for e in os.scandir(os.path.join(base, "final")) if e.is_dir()
        )
        for scene in scenes:
            self.sample_list.append(
                {
                    "name": scene,
                    "image": natsorted(glob(os.path.join(base, "final", scene, "frame_*.png"))),
                    "depth": natsorted(glob(os.path.join(base, "depth", scene, "frame_*.dpt"))),
                    "cam": natsorted(glob(os.path.join(base, "camdata_left", scene, "frame_*.cam"))),
                }
            )

    def _load_scene(self, paths: Dict) -> Dict:
        images = [imread_rgb01(p) for p in paths["image"]]
        depth = np.stack([read_dpt(p) for p in paths["depth"]])
        n = len(images)
        intr = np.zeros((n, 3, 3), np.float32)
        extr = np.zeros((n, 4, 4), np.float32)
        for i, cam_path in enumerate(paths["cam"]):
            m, nmat = read_cam(cam_path)
            intr[i] = m
            extr[i, :3] = nmat
            extr[i, 3, 3] = 1.0
        return {
            "image": np.stack(images),
            "depth": depth,
            "valid_depth": self._valid(depth),
            "intrinsics": intr,
            "extrinsics": extr,
        }
