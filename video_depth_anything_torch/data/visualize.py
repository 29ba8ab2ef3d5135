"""Dataset sanity visualizations (capability of reference
``datasets/visualisation_utils.py:1-60``): scene GIFs, RGB/depth grids, and
RGB-D back-projection to a 3-D point cloud for verifying
intrinsics/extrinsics (matplotlib 3-D instead of Open3D).

A copy of the JAX package's ``data/visualize.py``; imageio and matplotlib
are imported inside the functions that use them.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def save_scene_gif(sample: Dict, out_path: str, fps: int = 8, max_frames: int = 60) -> str:
    """RGB | depth side-by-side animated GIF for a dataset scene."""
    import imageio

    from video_depth_anything_torch.io.video import colorize_depth

    rgb = sample["image"]
    if rgb.dtype != np.uint8:
        rgb = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    depth_vis = colorize_depth(np.asarray(sample["depth"], np.float32))
    frames = [
        np.concatenate([rgb[i], depth_vis[i]], axis=1)
        for i in range(min(len(rgb), max_frames))
    ]
    imageio.mimsave(out_path, frames, duration=1.0 / fps, loop=0)
    return out_path


def backproject_to_points(
    depth: np.ndarray,
    intrinsics: np.ndarray,
    extrinsics: Optional[np.ndarray] = None,
    rgb: Optional[np.ndarray] = None,
    valid: Optional[np.ndarray] = None,
    stride: int = 4,
):
    """Depth map → world-frame 3-D points (and colors) for camera-parameter
    sanity checks (ref ``visualisation_utils.py:11-60``)."""
    h, w = depth.shape
    yy, xx = np.mgrid[0:h:stride, 0:w:stride]
    z = depth[::stride, ::stride]
    m = z > 0
    if valid is not None:
        m &= valid[::stride, ::stride]
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    x3 = (xx - cx) / fx * z
    y3 = (yy - cy) / fy * z
    pts_cam = np.stack([x3[m], y3[m], z[m], np.ones(m.sum())], axis=0)
    if extrinsics is not None:
        # extrinsics world->camera; invert to place points in world frame
        pts = (np.linalg.inv(extrinsics) @ pts_cam)[:3].T
    else:
        pts = pts_cam[:3].T
    colors = None
    if rgb is not None:
        colors = rgb[::stride, ::stride][m]
    return pts, colors


def plot_scene_pointcloud(
    sample: Dict, frame_ids=(0,), out_path: str = "scene_cloud.png", stride: int = 6
) -> str:
    """Project several frames of a scene into one world-frame point cloud
    plot — misaligned clouds reveal wrong extrinsics conventions."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    for t in frame_ids:
        extr = sample.get("extrinsics")
        pts, colors = backproject_to_points(
            np.asarray(sample["depth"][t], np.float32),
            np.asarray(sample["intrinsics"][t]),
            None if extr is None else np.asarray(extr[t]),
            rgb=np.asarray(sample["image"][t]),
            valid=np.asarray(sample["valid_depth"][t]),
            stride=stride,
        )
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=0.5, c=colors, alpha=0.6)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path
