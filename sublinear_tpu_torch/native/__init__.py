"""Host helpers in C++, built with g++ at first use and loaded with ctypes.

``coloring.cpp`` holds the greedy coloring of multicolor Gauss-Seidel.  The
first call compiles it with ``g++ -O3 -shared -fPIC`` into ``build/native/``
beside the package, under a name keyed by a hash of the source and the
flags (as ``ops/_kernels.py`` keys the CUDA libraries), so an edit
rebuilds it.  Nothing builds at import time.  Where g++ is missing or the
build fails, ``available()`` is False and the caller runs its NumPy loop,
which gives the same colors.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_tried = False


def _lib_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libslt_{source.stem}_{digest}.so"


def _build(source: Path, path: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(source), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed (exit {proc.returncode}) on "
                           f"{source.name}:\n{proc.stderr}")
    os.replace(tmp, path)


def get_lib():
    """The loaded helper library, built at first use; None when it cannot
    be built or loaded."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        source = _DIR / "coloring.cpp"
        path = _lib_path(source)
        try:
            if not path.exists():
                _build(source, path)
            lib = ctypes.CDLL(str(path))
        except (OSError, RuntimeError, subprocess.SubprocessError):
            return None
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.slt_greedy_coloring.restype = ctypes.c_int32
        lib.slt_greedy_coloring.argtypes = [i64p, i32p, i64p, i32p,
                                            ctypes.c_int64, i32p]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def greedy_coloring(indptr, indices, t_indptr, t_indices, n) -> np.ndarray:
    """Colors (int32, length n) of the greedy coloring of the pattern of
    A + A^T given as the CSR of A and of A^T (square, n x n)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    n = int(n)
    arrays = [np.ascontiguousarray(a, dt) for a, dt in (
        (indptr, np.int64), (indices, np.int32), (t_indptr, np.int64),
        (t_indices, np.int32))]
    # the C loop indexes colors[] with every column: check before it runs
    for ptr, idx in (arrays[:2], arrays[2:]):
        if (ptr.shape != (n + 1,) or ptr[0] != 0 or ptr[-1] != idx.size
                or np.any(np.diff(ptr) < 0)
                or (idx.size and (idx.min() < 0 or idx.max() >= n))):
            raise ValueError("greedy_coloring needs two valid n x n CSR "
                             "patterns")
    colors = np.zeros(n, dtype=np.int32)
    lib.slt_greedy_coloring(*arrays, n, colors)
    return colors
