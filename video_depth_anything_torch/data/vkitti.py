"""Virtual KITTI 2 (decode conventions of ``datasets/vkitti.py``).

16-bit PNG depth in centimeters (/100 → m, ``vkitti.py:194-195``,
max 655.35 m); per-frame intrinsics/extrinsics from the scene's
``intrinsic.txt`` / ``extrinsic.txt`` (row format ``frame cameraID
values...``, ``vkitti.py:95-147``); two cameras per scene×condition.

A copy of the JAX package's ``data/vkitti.py`` (numpy host code): the same
files give the same arrays.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Dict, Tuple

import cv2
import numpy as np

from video_depth_anything_torch.data.base import SceneDepthDataset, imread_rgb01, natsorted


def read_vkitti_intrinsics(path: str, camera_id: str) -> np.ndarray:
    rows = []
    with open(path) as f:
        next(f)
        for line in f:
            v = line.split()
            if v[1] == camera_id:
                k = np.eye(3, dtype=np.float32)
                k[0, 0], k[1, 1], k[0, 2], k[1, 2] = map(float, v[2:6])
                rows.append(k)
    return np.stack(rows)


def read_vkitti_extrinsics(path: str, camera_id: str) -> np.ndarray:
    rows = []
    with open(path) as f:
        next(f)
        for line in f:
            v = line.split()
            if v[1] == camera_id:
                # row layout (vkitti.py:118-147): r11 r12 r13 t1 r21 r22 r23
                # t2 r31 r32 r33 t3; extrinsics = T @ R
                vals = list(map(float, v[2:14]))
                r = np.eye(4)
                r[:3, :3] = np.array(vals).reshape(3, 4)[:, :3]
                t = np.eye(4)
                t[0, 3], t[1, 3], t[2, 3] = vals[3], vals[7], vals[11]
                rows.append((t @ r).astype(np.float32))
    return np.stack(rows)


class VKITTI(SceneDepthDataset):
    max_depth = 655.35
    min_depth = 0.0

    def __init__(self, root: str, cameras=("0", "1"), verbose: bool = False):
        super().__init__(root)
        self.verbose = verbose
        scene_dirs = []
        for scene in os.scandir(root):
            if scene.is_dir() and "Scene" in scene.name:
                for cond in os.scandir(scene.path):
                    if cond.is_dir():
                        scene_dirs.append(cond.path)
        for scene in natsorted(scene_dirs):
            for cam in cameras:
                self.sample_list.append(
                    {
                        "name": f"{os.path.relpath(scene, root).replace(os.sep, '_')}_cam{cam}",
                        "image": natsorted(
                            glob(os.path.join(scene, "frames", "rgb", f"Camera_{cam}", "rgb_*.jpg"))
                        ),
                        "depth": natsorted(
                            glob(os.path.join(scene, "frames", "depth", f"Camera_{cam}", "depth_*.png"))
                        ),
                        "intrinsics_path": os.path.join(scene, "intrinsic.txt"),
                        "extrinsics_path": os.path.join(scene, "extrinsic.txt"),
                        "camera_id": cam,
                    }
                )

    def _load_scene(self, paths: Dict) -> Dict:
        images, depths, idx_list = [], [], []
        for img_path, depth_path in zip(paths["image"], paths["depth"]):
            if self.verbose:
                assert self.extract_index(img_path) == self.extract_index(depth_path), (
                    img_path, depth_path)
            images.append(imread_rgb01(img_path))
            idx_list.append(self.extract_index(img_path))
            raw = cv2.imread(depth_path, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
            depths.append(raw.astype(np.float32) / 100.0)
        depth = np.stack(depths)
        intr = read_vkitti_intrinsics(paths["intrinsics_path"], paths["camera_id"])
        extr = read_vkitti_extrinsics(paths["extrinsics_path"], paths["camera_id"])
        return {
            "image": np.stack(images),
            "depth": depth,
            "valid_depth": self._valid(depth),
            "intrinsics": intr[idx_list],
            "extrinsics": extr[idx_list],
        }
