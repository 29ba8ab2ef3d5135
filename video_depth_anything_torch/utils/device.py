"""Device selection: the port runs on the card unless the caller asks for
the CPU, and never drops to the CPU on its own."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` or ``"cuda"`` → the current CUDA device, raising when there
    is none; ``"cpu"`` (or any explicit device) is taken as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev
