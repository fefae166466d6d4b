"""Build and load the hand-written CUDA kernels of ``csrc/``.

``csrc/csr_kernels.cu`` is compiled with nvcc for sm_90a into a shared
library with a plain C interface and loaded with ctypes.  The build happens
at first use, into ``build/kernels/`` beside the package, under a name keyed
by a hash of the source and the flags, so an edit rebuilds it.  Nothing here
runs at import time: the module imports on machines without nvcc or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "csr_kernels.cu"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found (looked on PATH, CUDA_HOME, CUDA_PATH "
                       "and the toolkit's default prefix)")


def build() -> tuple[Path, float, str]:
    """Compile the kernels if no library for this source exists yet.

    Returns ``(library path, seconds spent compiling, compiler log)``; the
    seconds are 0.0 and the log is the saved one when the library was
    already built.  A failed build raises with nvcc's stderr."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"libslt_csr_{digest}.so"
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists():
        return lib_path, 0.0, log_path.read_text() if log_path.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}) on "
                           f"{SOURCE.name}:\n{proc.stderr}")
    log = proc.stdout + proc.stderr
    log_path.write_text(log)
    os.replace(tmp, lib_path)
    return lib_path, seconds, log


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            path, _, _ = build()
            lib = ctypes.CDLL(str(path))
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.slt_csr_spmv.argtypes = [I, I, P, P, P, P, P, P, P]
            lib.slt_csr_spmv.restype = I
            lib.slt_neumann_step.argtypes = [I, I, P, P, P, P, P, P, P, P, P, P]
            lib.slt_neumann_step.restype = I
            lib.slt_cg_step.argtypes = [I, I, P, P, P, P, P, P, P, P, P, P,
                                        I, I, I, P, P]
            lib.slt_cg_step.restype = I
            lib.slt_error_string.argtypes = [I]
            lib.slt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
