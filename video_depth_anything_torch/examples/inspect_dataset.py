"""Dataset sanity inspection (the JAX ``examples/inspect_dataset.py``; the
reference's ``Test_dataset.ipynb``): load a scene, print each field's shape,
dtype and range, write an RGB | depth GIF and a point-cloud plot to check
the intrinsics and extrinsics.  Runs no model, so it takes no device; the
renderings need imageio and matplotlib.

    python -m video_depth_anything_torch.examples.inspect_dataset --dataset sintel \\
        --root DIR --scene 0
"""

import argparse

import numpy as np

from video_depth_anything_torch.data import get_dataset
from video_depth_anything_torch.data.visualize import plot_scene_pointcloud, save_scene_gif


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", required=True)
    p.add_argument("--root", required=True)
    p.add_argument("--scene", type=int, default=0)
    p.add_argument("--out_prefix", default="inspect")
    args = p.parse_args(argv)

    ds = get_dataset(args.dataset, args.root)
    print(f"{args.dataset}: {len(ds)} scenes")
    s = ds[args.scene]
    for k, v in s.items():
        if isinstance(v, np.ndarray):
            print(f"  {k:12s} {str(v.shape):20s} {str(v.dtype):10s} "
                  f"min {np.nanmin(v):.4g} max {np.nanmax(v):.4g}")
        else:
            print(f"  {k:12s} {v}")
    print("wrote", save_scene_gif(s, f"{args.out_prefix}_{s['name']}.gif"))
    if "intrinsics" in s:
        png = plot_scene_pointcloud(s, frame_ids=(0, min(5, len(s["image"]) - 1)),
                                    out_path=f"{args.out_prefix}_{s['name']}_cloud.png")
        print("wrote", png)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
