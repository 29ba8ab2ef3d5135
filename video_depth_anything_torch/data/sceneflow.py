"""SceneFlow — FlyingThings3D / Driving / Monkaa
(decode conventions of ``datasets/sceneflow.py``).

PFM disparity (``sceneflow.py:157-200``) converted to depth via
``focal·baseline/disparity`` with baseline 1.0 and focal 450 (15 mm
scenes) or 1050 (``sceneflow.py:278-291``); per-frame ``camera_data.txt``
extrinsics rows ``L|R`` + 16 values (``sceneflow.py:127-155``); frame
index offset 6 for FlyingThings TRAIN/TEST, 1 otherwise.

A copy of the JAX package's ``data/sceneflow.py`` (numpy host code): the same
files give the same arrays.
"""

from __future__ import annotations

import fnmatch
import os
import re
from glob import glob
from typing import Dict, Tuple

import numpy as np

from video_depth_anything_torch.data.base import SceneDepthDataset, imread_rgb01, natsorted


def read_pfm(path: str) -> Tuple[np.ndarray, float]:
    with open(path, "rb") as f:
        header = f.readline().decode("utf-8").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError(f"not a PFM file: {path}")
        dim_match = re.match(r"^(\d+)\s(\d+)\s$", f.readline().decode("utf-8"))
        if not dim_match:
            raise ValueError(f"malformed PFM header: {path}")
        width, height = map(int, dim_match.groups())
        scale = float(f.readline().decode("utf-8").strip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)).copy(), scale


def write_pfm(path: str, data: np.ndarray, scale: float = 1.0) -> None:
    with open(path, "wb") as f:
        f.write(b"Pf\n")
        f.write(f"{data.shape[1]} {data.shape[0]} \n".encode())
        f.write(f"{-scale}\n".encode())  # little-endian
        np.flipud(data).astype("<f4").tofile(f)


def read_camera_data(path: str, camera: str) -> np.ndarray:
    """``camera_data.txt`` rows ``L v0..v15`` / ``R v0..v15`` → (N, 4, 4)."""
    mats = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts and parts[0] == camera:
                vals = list(map(float, parts[1:17]))
                mats.append(np.array(vals, np.float32).reshape(4, 4))
    return np.stack(mats)


class SceneFlow(SceneDepthDataset):
    max_depth = 800.0
    min_depth = 0.0

    def __init__(
        self,
        root: str,
        is_test: bool = False,
        use_flyingthings: bool = True,
        use_driving: bool = True,
        use_monkaa: bool = True,
        camera: str = "L",
    ):
        super().__init__(root)
        self.camera = camera
        scenes = []
        clean = os.path.join(root, "frames_cleanpass")
        subsets = natsorted(e.name for e in os.scandir(clean) if e.is_dir())
        if use_flyingthings:
            split = "TEST" if is_test else "TRAIN"
            base = os.path.join(clean, split)
            if os.path.isdir(base):
                for letter in os.scandir(base):
                    if letter.is_dir():
                        for num in os.scandir(letter.path):
                            if num.is_dir():
                                scenes.append(os.path.join(split, letter.name, num.name))
        if use_driving and not is_test:
            for name in subsets:
                if fnmatch.fnmatch(name, "*_focallength"):
                    for entry in os.scandir(os.path.join(clean, name)):
                        if entry.is_dir():
                            scenes.append(os.path.join(name, entry.name, "slow"))
        if use_monkaa and not is_test:
            for name in subsets:
                if fnmatch.fnmatch(name, "*_x2"):
                    scenes.append(name)

        side = "left" if camera == "L" else "right"
        for scene in natsorted(scenes):
            self.sample_list.append(
                {
                    "name": scene.replace(os.sep, "_"),
                    "image": natsorted(
                        glob(os.path.join(clean, scene, side, "*.png"))
                    ),
                    "depth": natsorted(
                        glob(os.path.join(root, "disparity", scene, side, "*.pfm"))
                    ),
                    "extrinsics_path": os.path.join(
                        root, "camera_data", scene, "camera_data.txt"
                    ),
                    "scene": scene,
                }
            )

    @staticmethod
    def extract_index(path: str) -> int:
        return int(os.path.basename(path).split(".")[0])

    def _load_scene(self, paths: Dict) -> Dict:
        focal = 450.0 if "15mm_focallength" in paths["scene"] else 1050.0
        intr = np.array(
            [[focal, 0.0, 479.5], [0.0, focal, 269.5], [0.0, 0.0, 1.0]], np.float32
        )
        images, depths, idx_list = [], [], []
        offset = 6 if ("TRAIN" in paths["scene"] or "TEST" in paths["scene"]) else 1
        for img_path, disp_path in zip(paths["image"], paths["depth"]):
            images.append(imread_rgb01(img_path))
            idx_list.append(self.extract_index(img_path) - offset)
            disp, scale = read_pfm(disp_path)
            with np.errstate(divide="ignore"):
                depths.append(
                    np.where(disp == 0.0, 0.0, focal * 1.0 / (disp * scale)).astype(
                        np.float32
                    )
                )
        depth = np.stack(depths)
        extr = read_camera_data(paths["extrinsics_path"], self.camera)
        n = len(images)
        return {
            "image": np.stack(images),
            "depth": depth,
            "valid_depth": self._valid(depth),
            "intrinsics": np.tile(intr, (n, 1, 1)),
            "extrinsics": extr[idx_list],
        }
