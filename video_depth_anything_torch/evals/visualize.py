"""Evaluation visualizations (the JAX package's ``evals/visualize.py``;
capability of reference ``utils/vis_util.py``).

Per-frame comparison videos: RGB | GT | per-method prediction / error /
stability-over-time columns with a loss-curve panel
(``vis_util.py:17-208``), and the compact side-by-side "money plot"
(``vis_util.py:213-302``).  Rendered with matplotlib Agg and written
through the cv2 video writer.  Each renderer is split in two: ``*_frames``
returns the rendered uint8 frames, ``render_*`` writes them with
``io/video.save_video``.  matplotlib is imported inside the functions, so
that this module imports without it.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from video_depth_anything_torch.io.video import save_video


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _fig_to_rgb(fig) -> np.ndarray:
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())
    return buf[..., :3].copy()


def _stability_slice(depths: np.ndarray, x_frac: float = 0.5) -> np.ndarray:
    """(T, H, W) → (H, T): the vertical line at ``x_frac`` over time — the
    reference's qualitative temporal-consistency diagnostic
    (``vis_util.py:137-138,163-175``)."""
    x = int(depths.shape[2] * x_frac)
    return depths[:, :, x].T


def comparison_frames(
    rgb: np.ndarray,
    gt_depth: Optional[np.ndarray],
    predictions: Dict[str, np.ndarray],
    stability_line: float = 0.5,
    max_frames: Optional[int] = None,
) -> np.ndarray:
    """Per-frame grid: rows = [RGB+GT] + one per method; columns =
    prediction | abs error | stability slice.  uint8 ``(T, H, W, 3)``."""
    plt = _pyplot()
    methods = list(predictions)
    t_len = min(
        len(rgb),
        *(len(p) for p in predictions.values()),
        *( [len(gt_depth)] if gt_depth is not None else [] ),
    )
    if max_frames:
        t_len = min(t_len, max_frames)

    d_min = min(float(p.min()) for p in predictions.values())
    d_max = max(float(p.max()) for p in predictions.values())

    frames_out = []
    for t in range(t_len):
        fig, axs = plt.subplots(
            nrows=len(methods) + 1, ncols=3, figsize=(12, 3 * (len(methods) + 1))
        )
        axs = np.atleast_2d(axs)
        axs[0, 0].imshow(rgb[t])
        axs[0, 0].set_title("RGB")
        if gt_depth is not None:
            axs[0, 1].imshow(gt_depth[t], cmap="inferno")
            axs[0, 1].set_title("GT depth")
        axs[0, 2].axis("off")
        for r, m in enumerate(methods, start=1):
            pred = predictions[m]
            axs[r, 0].imshow(pred[t], cmap="inferno", vmin=d_min, vmax=d_max)
            axs[r, 0].set_title(m)
            if gt_depth is not None:
                axs[r, 1].imshow(np.abs(pred[t] - gt_depth[t]), cmap="viridis")
                axs[r, 1].set_title(f"{m} | error |")
            stab = _stability_slice(pred[: t + 1], stability_line)
            axs[r, 2].imshow(stab, cmap="inferno", aspect="auto", vmin=d_min, vmax=d_max)
            axs[r, 2].set_title(f"{m} stability @x={stability_line:.0%}")
        for ax in axs.ravel():
            ax.set_xticks([])
            ax.set_yticks([])
        fig.tight_layout()
        frames_out.append(_fig_to_rgb(fig))
        plt.close(fig)

    return np.stack(frames_out)


def render_comparison_video(
    rgb: np.ndarray,
    gt_depth: Optional[np.ndarray],
    predictions: Dict[str, np.ndarray],
    out_path: str,
    fps: float = 10,
    stability_line: float = 0.5,
    max_frames: Optional[int] = None,
) -> str:
    """``comparison_frames`` written to ``out_path``."""
    save_video(comparison_frames(rgb, gt_depth, predictions, stability_line, max_frames),
               out_path, fps=fps)
    return out_path


def money_plot_frames(
    rgb: np.ndarray,
    predictions: Dict[str, np.ndarray],
    max_frames: Optional[int] = None,
) -> np.ndarray:
    """RGB + one panel per method, single row (ref ``vis_util.py:213-302``).
    uint8 ``(T, H, W, 3)``."""
    plt = _pyplot()
    methods = list(predictions)
    t_len = min(len(rgb), *(len(p) for p in predictions.values()))
    if max_frames:
        t_len = min(t_len, max_frames)
    d_min = min(float(p.min()) for p in predictions.values())
    d_max = max(float(p.max()) for p in predictions.values())

    frames_out = []
    for t in range(t_len):
        fig, axs = plt.subplots(1, len(methods) + 1, figsize=(4 * (len(methods) + 1), 4))
        axs = np.atleast_1d(axs)
        axs[0].imshow(rgb[t])
        axs[0].set_title("RGB")
        for i, m in enumerate(methods, start=1):
            axs[i].imshow(predictions[m][t], cmap="inferno", vmin=d_min, vmax=d_max)
            axs[i].set_title(m)
        for ax in axs:
            ax.set_xticks([])
            ax.set_yticks([])
        fig.tight_layout()
        frames_out.append(_fig_to_rgb(fig))
        plt.close(fig)
    return np.stack(frames_out)


def render_money_plot(
    rgb: np.ndarray,
    predictions: Dict[str, np.ndarray],
    out_path: str,
    fps: float = 10,
    max_frames: Optional[int] = None,
) -> str:
    """``money_plot_frames`` written to ``out_path``."""
    save_video(money_plot_frames(rgb, predictions, max_frames), out_path, fps=fps)
    return out_path
