"""Kernel dispatch switch for measurement, and the recomputing backward.

The model's dispatch points (attention, temporal attention, the motion
module) send every shape that the JAX gates send to a Pallas kernel to the
matching CUDA kernel wrapper.  ``plain_reference()`` makes those dispatch
points call the plain PyTorch versions instead, so that a script can hold
the whole kernel path against the plain path on the same card.  The
wrappers themselves never read it: on a CUDA tensor a wrapper launches its
kernel or raises.

``recompute_vjp`` is the backward of the fused kernels whose JAX custom VJP
recomputes through the plain chain (the motion module, the output tail).
"""

from __future__ import annotations

import contextlib

import torch

_plain = False


def kernels_enabled() -> bool:
    return not _plain


@contextlib.contextmanager
def plain_reference():
    global _plain
    prev, _plain = _plain, True
    try:
        yield
    finally:
        _plain = prev


def recompute_vjp(fn, inputs, needs_input_grad, g):
    """Gradients of ``fn(*inputs)`` for the cotangent ``g``, recomputed
    with grad mode on: one entry per input, ``None`` where
    ``needs_input_grad`` says no."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(need) for t, need in zip(inputs, needs_input_grad)]
        wanted = [t for t in ins if t.requires_grad]
        grads = iter(torch.autograd.grad(fn(*ins), wanted, g) if wanted else ())
    return [next(grads) if t.requires_grad else None for t in ins]
