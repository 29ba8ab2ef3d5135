"""TartanAir (decode conventions of ``datasets/tartanair.py``).

``.npy`` float depth; poses as x,y,z + quaternion converted to SE(3) and
conjugated into the NED frame (``tartanair.py:28-37,106-125``); fixed
intrinsics fx=fy=320, cx=320, cy=240; Hard/Easy settings × left/right
cameras; depth clipped at 800 m (sky).

A copy of the JAX package's ``data/tartanair.py`` (numpy host code): the same
files give the same arrays.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Dict

import numpy as np

from video_depth_anything_torch.data.base import SceneDepthDataset, imread_rgb01, natsorted

INTRINSICS = np.array(
    [[320.0, 0.0, 320.0], [0.0, 320.0, 240.0], [0.0, 0.0, 1.0]], np.float32
)

# NED conjugation (ref tartanair.py:110-114)
_T_NED = np.array(
    [[0, 0, 1, 0], [1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1]], np.float32
)


def quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    """(x, y, z, w) quaternion → 3×3 rotation (scipy convention)."""
    x, y, z, w = q
    n = x * x + y * y + z * z + w * w
    s = 0.0 if n == 0 else 2.0 / n
    return np.array(
        [
            [1 - s * (y * y + z * z), s * (x * y - z * w), s * (x * z + y * w)],
            [s * (x * y + z * w), 1 - s * (x * x + z * z), s * (y * z - x * w)],
            [s * (x * z - y * w), s * (y * z + x * w), 1 - s * (x * x + y * y)],
        ]
    )


def poses_to_extrinsics(pose_file: str) -> np.ndarray:
    """pose_left.txt rows ``x y z qx qy qz qw`` → (N, 4, 4) world→camera.

    TartanAir poses are camera→world in the NED frame; after the NED
    conjugation (``T @ SE @ T⁻¹``, ref ``tartanair.py:106-125``) the result
    is inverted so the dataset contract (world→camera extrinsics, consumed
    by TAE reprojection) holds.  The reference returns the un-inverted pose
    and never consumes it for metrics (its ``Cam_to_World`` flag/comment is
    self-contradictory) — documented deviation.
    """
    traj = np.loadtxt(pose_file)
    if traj.ndim == 1:
        traj = traj[None]
    t_inv = np.linalg.inv(_T_NED)
    out = []
    for row in traj:
        se = np.eye(4)
        se[:3, :3] = quat_to_rotmat(row[3:7])
        se[:3, 3] = row[0:3]
        out.append(np.linalg.inv(_T_NED @ se @ t_inv))
    return np.stack(out).astype(np.float32)


class TartanAir(SceneDepthDataset):
    max_depth = 800.0
    min_depth = 0.0

    def __init__(self, root: str, cameras=("left", "right")):
        super().__init__(root)
        scene_dirs = []
        for env in os.scandir(root):
            if env.is_dir():
                for setting in ("Hard", "Easy"):
                    base = os.path.join(env.path, setting)
                    if os.path.isdir(base):
                        for traj in os.scandir(base):
                            if traj.is_dir():
                                scene_dirs.append(traj.path)
        for scene in natsorted(scene_dirs):
            for cam in cameras:
                imgs = natsorted(glob(os.path.join(scene, f"image_{cam}", "*.png")))
                if not imgs:
                    continue
                self.sample_list.append(
                    {
                        "name": f"{os.path.relpath(scene, root).replace(os.sep, '_')}_{cam}",
                        "image": imgs,
                        "depth": natsorted(glob(os.path.join(scene, f"depth_{cam}", "*.npy"))),
                        "pose_path": os.path.join(scene, f"pose_{cam}.txt"),
                    }
                )

    def _load_scene(self, paths: Dict) -> Dict:
        images = [imread_rgb01(p) for p in paths["image"]]
        depth = np.stack([np.load(p).astype(np.float32) for p in paths["depth"]])
        valid = self._valid(depth)
        n = len(images)
        return {
            "image": np.stack(images),
            "depth": np.clip(depth, 0.0, self.max_depth),
            "valid_depth": valid,
            "intrinsics": np.tile(INTRINSICS, (n, 1, 1)),
            "extrinsics": poses_to_extrinsics(paths["pose_path"])[:n],
        }
