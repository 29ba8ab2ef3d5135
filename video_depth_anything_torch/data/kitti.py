"""KITTI depth-annotated scenes (decode conventions of ``datasets/Kitti.py``).

Layout: ``<root>/kitti_depth/data_depth_annotated/{train,val}/<date>_drive_*``
holds 16-bit PNG projected-lidar depth (value/256 → meters,
``Kitti.py:240-242``); raw RGB lives under ``<root>/kitti_raw/<date>/...``
with cameras image_02 / image_03 (two scenes per drive,
``Kitti.py:62-81``); intrinsics come from ``calib_cam_to_cam.txt``
(``K_cam2``/``K_cam3`` = rectified projection top-left 3×3,
``Kitti.py:83-191``).  KITTI GT skips the first/last 5 frames — images are
matched to depth by embedded frame index.

A copy of the JAX package's ``data/kitti.py`` (numpy host code): the same
files give the same arrays.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Dict

import cv2
import numpy as np

from video_depth_anything_torch.data.base import SceneDepthDataset, imread_rgb01, natsorted


def read_kitti_calib(cam_path: str) -> Dict[str, np.ndarray]:
    """Parse ``calib_cam_to_cam.txt`` into rectified K matrices per camera."""
    data = {}
    with open(os.path.join(cam_path, "calib_cam_to_cam.txt")) as f:
        for line in f:
            if ":" in line:
                key, value = line.split(":", 1)
            else:
                parts = line.split(" ", 1)
                if len(parts) != 2:
                    continue
                key, value = parts
            try:
                data[key.strip()] = np.array([float(x) for x in value.split()])
            except ValueError:
                continue
    out = {}
    for cam in range(4):
        p = data[f"P_rect_0{cam}"].reshape(3, 4)
        out[f"K_cam{cam}"] = p[:3, :3]
    return out


class KITTI(SceneDepthDataset):
    max_depth = 255.9
    min_depth = 0.0

    def __init__(self, root: str, is_val: bool = False, cameras=("image_03", "image_02"), verbose: bool = False):
        super().__init__(root)
        self.verbose = verbose
        mode = "val" if is_val else "train"
        depth_root = os.path.join(root, "kitti_depth", "data_depth_annotated", mode)
        if not os.path.isdir(depth_root):
            raise FileNotFoundError(depth_root)
        scenes = natsorted(
            e.name for e in os.scandir(depth_root) if "_drive_" in e.name
        )
        for scene in scenes:
            date = scene.split("_drive_")[0]
            for cam in cameras:
                self.sample_list.append(
                    {
                        "name": f"{scene}_{cam}",
                        "image": natsorted(
                            glob(os.path.join(root, "kitti_raw", date, scene, cam, "data", "*.png"))
                        ),
                        "depth": natsorted(
                            glob(os.path.join(depth_root, scene, "proj_depth", "groundtruth", cam, "*.png"))
                        ),
                        "cam_path": os.path.join(root, "kitti_raw", date),
                        "camera_id": cam[-1],
                    }
                )

    @staticmethod
    def extract_index(path: str) -> int:
        return int(os.path.basename(path).split(".")[0])

    def _load_scene(self, paths: Dict) -> Dict:
        n = len(paths["depth"])
        images, depths = [], []
        for depth_path in paths["depth"]:
            idx_img = self.extract_index(depth_path)
            if self.verbose:
                # opt-in image/depth index agreement check (ref Kitti.py:234-237)
                assert self.extract_index(paths["image"][idx_img]) == idx_img, (
                    paths["image"][idx_img], depth_path)
            images.append(imread_rgb01(paths["image"][idx_img]))
            raw = cv2.imread(depth_path, cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH)
            depths.append(raw.astype(np.float32) / 256.0)
        depth = np.stack(depths)
        k = read_kitti_calib(paths["cam_path"])[f"K_cam{paths['camera_id']}"]
        return {
            "image": np.stack(images),
            "depth": depth,
            "valid_depth": self._valid(depth),
            "intrinsics": np.tile(k.astype(np.float32), (n, 1, 1)),
            # reference leaves KITTI extrinsics unimplemented (Kitti.py:226)
        }
