"""Kernel dispatch switch for measurement.

The model's dispatch points (attention, temporal attention, the motion
module) send every shape that the JAX gates send to a Pallas kernel to the
matching CUDA kernel wrapper.  ``plain_reference()`` makes those dispatch
points call the plain PyTorch versions instead, so that a script can hold
the whole kernel path against the plain path on the same card.  The
wrappers themselves never read it: on a CUDA tensor a wrapper launches its
kernel or raises.
"""

from __future__ import annotations

import contextlib

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
