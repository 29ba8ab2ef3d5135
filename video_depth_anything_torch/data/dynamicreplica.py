"""DynamicReplica (decode conventions of ``datasets/dynamicreplica.py``).

Depth stored as float16 bit-patterns inside 16-bit PNGs
(``dynamicreplica.py:28-38``); frame annotations in a gzipped JSON listing
per-frame image/depth/mask paths and a pytorch3d-style viewpoint whose NDC
intrinsics are converted to pixels (``dynamicreplica.py:42-107``).

A copy of the JAX package's ``data/dynamicreplica.py`` (numpy host code): the same
files give the same arrays.
"""

from __future__ import annotations

import gzip
import json
import os
from typing import Dict, List

import cv2
import numpy as np
from PIL import Image

from video_depth_anything_torch.data.base import SceneDepthDataset, imread_rgb01


def load_float16_png_depth(path: str) -> np.ndarray:
    """uint16 PNG bits reinterpreted as float16 → float32 meters."""
    with Image.open(path) as pil:
        depth = (
            np.frombuffer(np.array(pil, dtype=np.uint16), dtype=np.float16)
            .astype(np.float32)
            .reshape((pil.size[1], pil.size[0]))
        )
    return depth


def viewpoint_to_camera(cam: Dict, image_size) -> Dict[str, np.ndarray]:
    """NDC viewpoint → pixel intrinsics + 4×4 extrinsics
    (``dynamicreplica.py:42-107,246-252``: E = R-as-4×4 + T-in-last-column)."""
    half_wh = np.array(list(reversed(image_size)), np.float64) / 2.0
    fmt = cam["intrinsics_format"].lower()
    if fmt == "ndc_norm_image_bounds":
        rescale = half_wh
    elif fmt == "ndc_isotropic":
        rescale = half_wh.min()
    else:
        raise ValueError(f"unknown intrinsics format: {fmt}")
    pp_px = half_wh - np.asarray(cam["principal_point"], np.float64) * rescale
    f_px = np.asarray(cam["focal_length"], np.float64) * rescale
    k = np.diag([f_px[0], f_px[1], 1.0]).astype(np.float32)
    k[:2, 2] = pp_px
    extr = np.eye(4, dtype=np.float32)
    extr[:3, :3] = np.asarray(cam["R"], np.float32)
    extr[:3, 3] = np.asarray(cam["T"], np.float32)
    return {"intrinsics": k, "extrinsics": extr}


class DynamicReplica(SceneDepthDataset):
    # reference bounds (dynamicreplica.py:129-130): float16 max / official min
    max_depth = 65_504.0
    min_depth = 1e-5

    def __init__(self, root: str, split: str = "train"):
        super().__init__(root)
        anno_file = os.path.join(root, split, f"frame_annotations_{split}.jgz")
        with gzip.open(anno_file, "rt", encoding="utf8") as z:
            annots: List[Dict] = json.load(z)

        cur_key = None
        scene: Dict | None = None
        for a in annots:
            key = (a["sequence_name"], a["camera_name"])
            if key != cur_key:
                if scene is not None:
                    self.sample_list.append(scene)
                cur_key = key
                scene = {
                    "name": f"{a['sequence_name']}_{a['camera_name']}",
                    "image": [],
                    "image_size": [],
                    "depth": [],
                    "depth_scale": [],
                    "mask": [],
                    "cam": [],
                }
            scene["image"].append(os.path.join(root, split, a["image"]["path"]))
            scene["image_size"].append(a["image"]["size"])
            scene["depth"].append(os.path.join(root, split, a["depth"]["path"]))
            scene["depth_scale"].append(a["depth"]["scale_adjustment"])
            scene["mask"].append(os.path.join(root, split, a["depth"]["mask_path"]))
            scene["cam"].append(a["viewpoint"])
        if scene is not None:
            self.sample_list.append(scene)

    def _load_scene(self, paths: Dict) -> Dict:
        n = len(paths["image"])
        images, depths, masks = [], [], []
        intr = np.zeros((n, 3, 3), np.float32)
        extr = np.zeros((n, 4, 4), np.float32)
        for i in range(n):
            images.append(imread_rgb01(paths["image"][i]))
            depths.append(load_float16_png_depth(paths["depth"][i]))
            m = cv2.imread(paths["mask"][i]).astype(np.float32) / 255.0
            masks.append(m.mean(axis=-1))
            cam = viewpoint_to_camera(paths["cam"][i], paths["image_size"][i])
            intr[i] = cam["intrinsics"]
            extr[i] = cam["extrinsics"]
        depth = np.stack(depths)
        return {
            "image": np.stack(images),
            "depth": depth,
            "valid_depth": self._valid(depth),
            "depth_mask": np.stack(masks) > 0.5,
            "intrinsics": intr,
            "extrinsics": extr,
        }
