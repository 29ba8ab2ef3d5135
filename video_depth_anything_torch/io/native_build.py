"""Build and load the repo's native host libraries (``native/*.cpp``).

``native/preproc.cpp`` (fused resize and normalise of uint8 frames, and
the window gather) and ``native/decode.cpp`` (libav decode with the stride
in the decode loop) are compiled with ``g++`` and the flags of
``native/Makefile``, at first use, into the git-ignored
``video_depth_anything_torch/_build/``.  Nothing is written under
``native/`` and the libraries committed there are never loaded: they were
built with ``-march=native`` on some other host, and an instruction this
host lacks would kill the process with SIGILL, which ctypes cannot catch.
For the same reason a library's name carries a hash of its source, the
flags, the compiler and this host's CPU model and flags, so that a build
directory copied to another machine is rebuilt there, never loaded.

Where the compiler has no OpenMP runtime (``-fopenmp`` fails: no
``libgomp.spec``), the source is built again without ``-fopenmp``: its
``#pragma omp`` loops then compile to the same loops on one thread, and
``status()`` says so.

``load(name)`` returns the loaded library or ``None``; ``status()`` says
for each library whether it loaded, from where, or why not (no compiler,
no libav headers, a failed ``dlopen``).  Callers fall back to their cv2
paths on ``None``, as the JAX package's bindings do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

_PKG = Path(__file__).resolve().parent.parent
NATIVE_DIR = _PKG.parent / "native"
BUILD_DIR = _PKG / "_build"
# native/Makefile:1-11
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-fopenmp", "-Wall", "-std=c++17")
LIBS = {"preproc": (), "decode": ("-lavformat", "-lavcodec", "-lavutil", "-lswscale")}

_lock = threading.Lock()
_libs: Dict[str, Optional[ctypes.CDLL]] = {}
_status: Dict[str, str] = {}


def _cxx() -> Optional[str]:
    return shutil.which(os.environ.get("CXX", "g++"))


def _host_cpu() -> str:
    """This host's CPU model and feature flags: what ``-march=native``
    compiles for."""
    lines = []
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags")):
                    lines.append(line.strip())
                    if len(lines) == 2:
                        break
    except OSError:
        pass
    return platform.machine() + "\n" + "\n".join(lines)


def lib_path(name: str, cxx: str, flags=CXXFLAGS) -> Path:
    h = hashlib.sha256()
    h.update((NATIVE_DIR / f"{name}.cpp").read_bytes())
    h.update(" ".join(tuple(flags) + LIBS[name]).encode())
    h.update(cxx.encode())
    h.update(_host_cpu().encode())
    return BUILD_DIR / f"libvda_{name}_{h.hexdigest()[:16]}.so"


def _compile(name: str, cxx: str, flags) -> Path:
    """The library of ``native/<name>.cpp`` under ``flags``, compiled unless
    a build for this source, these flags and this host exists.  Raises with
    the compiler's errors on failure."""
    path = lib_path(name, cxx, flags)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *flags, "-shared", "-o", str(tmp), str(NATIVE_DIR / f"{name}.cpp"), *LIBS[name]]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        lines = [ln for ln in proc.stdout.splitlines() if "error" in ln] or proc.stdout.splitlines()
        raise RuntimeError(f"g++ failed for native/{name}.cpp: " + " | ".join(lines[:3]))
    os.replace(tmp, path)
    return path


def _build(name: str):
    """``(path, note)``: the Makefile's flags, else the same without
    ``-fopenmp`` (``note`` then says why)."""
    cxx = _cxx()
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on this host")
    try:
        return _compile(name, cxx, CXXFLAGS), ""
    except RuntimeError as first:
        try:
            path = _compile(name, cxx, tuple(f for f in CXXFLAGS if f != "-fopenmp"))
        except RuntimeError:
            raise first from None
        return path, f" without -fopenmp, its loops on one thread ({first})"


def load(name: str) -> Optional[ctypes.CDLL]:
    """The loaded library ``name`` (``preproc`` or ``decode``), built at
    first use; ``None`` (and the reason in ``status()``) when it cannot be
    built or loaded."""
    with _lock:
        if name not in _libs:
            try:
                path, note = _build(name)
                _libs[name] = ctypes.CDLL(str(path))
                _status[name] = f"built from native/{name}.cpp{note}: {path}"
            except Exception as e:  # noqa: BLE001 - the caller falls back to cv2
                _libs[name] = None
                _status[name] = f"not built: {e}"
        return _libs[name]


def status() -> Dict[str, str]:
    """For each library: where it was loaded from, or why it was not."""
    for name in LIBS:
        load(name)
    return dict(_status)
