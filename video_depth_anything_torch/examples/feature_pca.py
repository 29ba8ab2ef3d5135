"""Motion-module feature visualisation (the JAX ``examples/feature_pca.py``;
the reference's ``Test_singleImage_processing.py:67-201``): each DPT
level's pre-motion features of two frames (``encode_level_features``, on
the card unless ``--device cpu``), projected on their top three principal
components and drawn as RGB maps beside the input, a manual check of the
features' temporal stability.  The drawing needs matplotlib.

    python -m video_depth_anything_torch.examples.feature_pca video.mp4 [out.png] [--device cuda]
"""

import argparse
from typing import List, Tuple

import numpy as np
import torch


def pca_rgb(feat: np.ndarray) -> np.ndarray:
    """(H, W, C) features → (H, W, 3) image from the top-3 principal
    components, each normalised to [0, 1]."""
    h, w, c = feat.shape
    flat = feat.reshape(-1, c).astype(np.float64)
    flat = flat - flat.mean(axis=0)
    _, _, vt = np.linalg.svd(flat, full_matrices=False)
    proj = flat @ vt[:3].T
    proj = proj - proj.min(axis=0)
    proj = proj / (proj.max(axis=0) + 1e-8)
    return proj.reshape(h, w, 3)


def level_features(video: str, device: str = "cuda",
                   input_size: int = 252) -> Tuple[np.ndarray, List[np.ndarray]]:
    """(the first two frames, the four levels' features ``(2, h_l, w_l,
    C_l)`` fp32 on the host) of a seeded fp32 vits."""
    from video_depth_anything_torch.io.video import read_video_frames
    from video_depth_anything_torch.models.vda import VDAModel
    from video_depth_anything_torch.utils.transform import preprocess_frames

    model = VDAModel("vits", device=device, dtype=torch.float32)
    model.init_params(seed=0)
    frames, _ = read_video_frames(video, process_length=2, max_res=480)
    pre = preprocess_frames(frames, input_size=input_size)
    with torch.inference_mode():
        feats = model.module.encode_level_features(torch.from_numpy(pre).to(model.device))
    return frames, [f.float().cpu().numpy() for f in feats]


def render(frames: np.ndarray, feats: List[np.ndarray], out_path: str) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axs = plt.subplots(2, 5, figsize=(20, 8))
    for row in range(2):
        axs[row, 0].imshow(frames[row])
        axs[row, 0].set_title(f"frame {row}")
        for lvl in range(4):
            fmap = feats[lvl][row]
            axs[row, lvl + 1].imshow(pca_rgb(fmap))
            axs[row, lvl + 1].set_title(
                f"level {lvl + 1} PCA  {fmap.shape[0]}x{fmap.shape[1]}x{fmap.shape[2]}")
    for ax in axs.ravel():
        ax.set_xticks([])
        ax.set_yticks([])
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("video")
    p.add_argument("out", nargs="?", default="feature_pca.png")
    p.add_argument("--input_size", type=int, default=252)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    frames, feats = level_features(args.video, args.device, args.input_size)
    print("levels: " + ", ".join("x".join(map(str, f.shape)) for f in feats))
    print(f"wrote {render(frames, feats, args.out)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
