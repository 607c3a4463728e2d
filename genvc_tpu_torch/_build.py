"""Build the port's hand-written CUDA kernels with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``_build/lib<name>-<hash>.so`` (the hash is of the source and the
shared ``csrc/*.cuh`` headers, so an edited kernel or header rebuilds), which
is loaded with ``ctypes``. Nothing here runs at import time: the first launch
of a kernel builds it, and :func:`build_all` builds several at once, one
``nvcc`` process per source, all started together.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _lib_path(name: str) -> tuple[str, str]:
    """(source, library path); the library is named by a digest of the
    source and of every ``csrc/*.cuh`` header, so an edit of either
    rebuilds."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    h = hashlib.sha256()
    for path in [src] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start ``nvcc`` for one source into a temporary file; returns
    (process, tmp, dst) or None when the library is already built."""
    src, dst = _lib_path(name)
    if os.path.exists(dst):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, dst


def _finish(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp, dst = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, dst)  # atomic: a reader never sees a half-written .so
    return out


def build_all(names) -> dict[str, str]:
    """Compile every named kernel source in parallel; returns nvcc's output
    (register and shared-memory use from ``-Xptxas -v``) per name."""
    with _lock:
        started = {n: _start(n) for n in names}
        return {n: _finish(n, s) for n, s in started.items()}


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` as a ctypes library."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(_lib_path(name)[1])
        return _loaded[name]
