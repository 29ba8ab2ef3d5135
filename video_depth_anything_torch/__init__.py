"""PyTorch/CUDA port of the video depth model for one NVIDIA H100.

Runs on the card by default (hand-written CUDA kernels under ``csrc/``);
pass ``device="cpu"`` for the plain PyTorch path.
"""

from video_depth_anything_torch.config import get_model_config  # noqa: F401
