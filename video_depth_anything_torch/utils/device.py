"""Device selection and device→host transfers.

The port runs on the card unless the caller asks for the CPU, and never
drops to the CPU on its own.  ``transfer_cast`` and ``start_host_transfer``
serve the streaming pipeline's one-step-lag emit: a depth map's copy to the
host starts as soon as it is enqueued and overlaps the next step.
"""

from __future__ import annotations

import numpy as np
import torch

TRANSFER_DTYPES = {"fp32": torch.float32, "fp16": torch.float16}


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


def transfer_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in the dtype of its device→host copy: fp16 halves the bytes of
    every emitted depth map (about 3 significant digits), fp32 keeps them."""
    return x if x.dtype == dtype else x.to(dtype)


class HostTransfer:
    """A device→host copy in flight: ``numpy()`` waits for it and returns
    fp32.  CPU tensors are taken as they are."""

    def __init__(self, x: torch.Tensor):
        if x.device.type == "cpu":
            self.host, self.event = x, None
            return
        self.host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        self.host.copy_(x, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.float().numpy()


def start_host_transfer(x: torch.Tensor) -> HostTransfer:
    """Start copying ``x`` into pinned host memory on the current stream,
    without blocking the host."""
    return HostTransfer(x)
