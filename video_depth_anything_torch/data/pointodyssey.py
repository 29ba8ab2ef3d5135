"""PointOdyssey (a copy of the JAX package's loader; decode conventions of
the reference ``datasets/pointodyssey.py``).

16-bit PNG depth scaled by /65535·1000 → meters
(``pointodyssey.py:108-110``); per-scene ``anno.npz`` holds per-frame
``intrinsics``/``extrinsics`` arrays indexed by the image frame index.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Dict

import cv2
import numpy as np

from video_depth_anything_torch.data.base import SceneDepthDataset, imread_rgb01, natsorted


class PointOdyssey(SceneDepthDataset):
    max_depth = 1_000.0
    min_depth = 0.0

    def __init__(self, root: str, split: str = "train", verbose: bool = False):
        super().__init__(root)
        self.verbose = verbose
        base = os.path.join(root, split)
        scenes = natsorted(e.name for e in os.scandir(base) if e.is_dir())
        for scene in scenes:
            self.sample_list.append(
                {
                    "name": scene,
                    "image": natsorted(glob(os.path.join(base, scene, "rgbs", "rgb_*.jpg"))),
                    "depth": natsorted(glob(os.path.join(base, scene, "depths", "depth_*.png"))),
                    "anno": os.path.join(base, scene, "anno.npz"),
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
            raw = cv2.imread(depth_path, cv2.IMREAD_UNCHANGED).astype(np.float32)
            depths.append(raw / 65_535.0 * 1_000.0)
        depth = np.stack(depths)
        anno = np.load(paths["anno"])
        return {
            "image": np.stack(images),
            "depth": depth,
            "valid_depth": self._valid(depth),
            "intrinsics": anno["intrinsics"][idx_list].astype(np.float32),
            "extrinsics": anno["extrinsics"][idx_list].astype(np.float32),
        }
