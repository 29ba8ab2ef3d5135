"""Scene dataset base class (a copy of the JAX package's numpy
``data/base.py``): each item is an entire scene as host arrays —
``image (N, H, W, 3) float32 [0,1]``, ``depth (N, H, W)`` metric meters,
``valid_depth`` bool, ``intrinsics (N, 3, 3)``, ``extrinsics (N, 4, 4)``.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import cv2
import numpy as np


def natsorted(items):
    """Natural sort (numeric-aware), replacing the natsort dependency."""

    def key(s):
        return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", str(s))]

    return sorted(items, key=key)


def imread_rgb01(path: str) -> np.ndarray:
    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0


class SceneDepthDataset:
    """Base: subclasses fill ``sample_list`` (one path-dict per scene) and
    implement ``_load_scene``."""

    max_depth: float = 80.0
    min_depth: float = 0.0

    def __init__(self, root: Optional[str] = None):
        if root is None or not os.path.isdir(root):
            raise FileNotFoundError(
                f"{type(self).__name__}: dataset root not found: {root!r}"
            )
        self.root = root
        self.sample_list: List[Dict] = []

    def __len__(self) -> int:
        return len(self.sample_list)

    def __getitem__(self, idx: int) -> Dict:
        sample = self._load_scene(self.sample_list[idx])
        sample.setdefault("name", self.sample_list[idx].get("name", f"scene_{idx:04d}"))
        return sample

    def _load_scene(self, paths: Dict) -> Dict:
        raise NotImplementedError

    def _valid(self, depth: np.ndarray) -> np.ndarray:
        return (depth > self.min_depth) & (depth < self.max_depth)

    @staticmethod
    def extract_index(path: str) -> int:
        base = os.path.basename(path).split(".")[0]
        return int(base.split("_")[-1])
