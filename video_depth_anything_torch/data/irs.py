"""IRS indoor stereo (decode conventions of ``datasets/irs.py``).

EXR disparity converted to depth via ``baseline·fx / disparity`` with
baseline 0.1 m and fixed intrinsics fx=fy=480, cx=480, cy=270
(``irs.py:96-101,173-175``).  EXR decode goes through OpenCV (enabled by
``OPENCV_IO_ENABLE_OPENEXR=1``, which ``load_exr`` sets unless it is set),
not the OpenEXR python module; a build without the codec raises a clear
error.

A copy of the JAX package's ``data/irs.py`` (numpy host code): the same
files give the same arrays.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Dict

import numpy as np

from video_depth_anything_torch.data.base import SceneDepthDataset, imread_rgb01, natsorted

INTRINSICS = np.array(
    [[480.0, 0.0, 480.0], [0.0, 480.0, 270.0], [0.0, 0.0, 1.0]], np.float32
)
BASELINE = 0.1  # meters


def load_exr(path: str) -> np.ndarray:
    os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
    import cv2

    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise RuntimeError(
            f"cannot decode EXR {path}; this OpenCV build may lack EXR "
            "support (set OPENCV_IO_ENABLE_OPENEXR=1 before importing cv2)"
        )
    if img.ndim == 3:
        img = img[..., 0]
    return img.astype(np.float32)


class IRS(SceneDepthDataset):
    max_depth = 100.0
    min_depth = 0.0

    def __init__(self, root: str):
        super().__init__(root)
        scene_dirs = natsorted(e.path for e in os.scandir(root) if e.is_dir())
        for scene in scene_dirs:
            imgs = natsorted(glob(os.path.join(scene, "l_*.png")))
            if not imgs:
                continue
            self.sample_list.append(
                {
                    "name": os.path.basename(scene),
                    "image": imgs,
                    "disparity": natsorted(glob(os.path.join(scene, "d_*.exr"))),
                }
            )

    def _load_scene(self, paths: Dict) -> Dict:
        images, depths = [], []
        for img_path, disp_path in zip(paths["image"], paths["disparity"]):
            images.append(imread_rgb01(img_path))
            disp = load_exr(disp_path)
            with np.errstate(divide="ignore"):
                depths.append(
                    np.where(disp != 0.0, BASELINE * INTRINSICS[0, 0] / disp, 0.0)
                )
        depth = np.stack(depths).astype(np.float32)
        n = len(images)
        return {
            "image": np.stack(images),
            "depth": np.clip(depth, 0.0, self.max_depth),
            "valid_depth": self._valid(depth),
            "intrinsics": np.tile(INTRINSICS, (n, 1, 1)),
        }
