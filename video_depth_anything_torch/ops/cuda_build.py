"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  The build
runs at first use, one ``nvcc`` process per source, all started together.
Libraries land in ``video_depth_anything_torch/_build/`` (git-ignored),
named by a hash of the source, the headers it includes and the flags, so a
stale library is never loaded and a header change rebuilds only its
includers.  A failed build raises with the compiler's output;
nothing falls back to another path.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()`` as an int; ``check`` turns a non-zero code into an
exception.  ``no_history`` is the guard of every raw launch function.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("flash_attention", "flash_attention_bwd", "temporal_attention", "motion_module",
           "motion_module_split64", "motion_module_split128", "motion_module_split256",
           "motion_module_split384", "output_tail", "resize_conv",
           "attention_variants_hopper", "flash_attention_f32", "temporal_attention_f32",
           "motion_module_f32", "motion_module_wide", "temporal_attention_any",
           "flash_attention_wide", "temporal_attention_any_f32")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources_of(name: str) -> list:
    """``csrc/<name>.cu`` and the ``csrc`` headers it includes, directly or
    through another of them."""
    todo, seen = [CSRC / f"{name}.cu"], []
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.append(f)
        todo += [CSRC / m for m in re.findall(r'^#include "([^"]+)"', f.read_text(), re.M)]
    return sorted(seen)


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in _sources_of(name):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every kernel library that is not built yet, in parallel;
    return the library paths.  Raises with the compiler output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in SOURCES}
    procs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, path)
    errors = []
    for name, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(out)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{out}")
        else:
            os.replace(tmp, path)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all at first use."""
    with _lock:
        if name not in _libs:
            paths = build_all()
            _libs[name] = ctypes.CDLL(str(paths[name]))
        return _libs[name]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def no_history(what: str, *tensors) -> None:
    """Raise where a raw kernel launch would drop gradients: the launches
    keep no autograd history, so with grad mode on and an input that
    requires a gradient the caller must go through the op's
    ``torch.autograd.Function``."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} keeps no autograd history and an input requires a gradient; call it "
            "through its autograd Function (FlashAttentionFn, TemporalAttentionFn, "
            "FusedMotionModuleFn, OutputTailFn, ResizeConvFn)")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    """The current stream of ``t``'s card, as the raw handle the C entry
    points take: read without building a ``torch.cuda.Stream`` (as
    PyTorch's own Triton launcher reads it), which would cost a small
    kernel's launch several microseconds of host time."""
    import torch

    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(t.device.index))
