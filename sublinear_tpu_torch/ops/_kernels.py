"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` is compiled with nvcc for sm_90a into a shared library
with a plain C interface and loaded with ctypes.  The build happens at first
use, into ``build/kernels/`` beside the package, under a name keyed by a
hash of the source and the flags, so an edit rebuilds it.  ``build`` starts
one nvcc per source, all at once.  Nothing here runs at import time: the
module imports on machines without nvcc or a card.
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

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argument types of each library's entry points (all return an int error)
SIGNATURES = {
    "csr_kernels": {
        "slt_csr_spmv": [_I, _I] + [_P] * 8,
        "slt_neumann_chain": [_I, _I] + [_P] * 11 + [_I, _P],
        "slt_cg_chain": [_I] * 3 + [_P] * 12 + [_I, _P, _P],
    },
    "dense_kernels": {
        "slt_dense_neumann": [_I, _I, _I] + [_P] * 6 + [_I] + [_P] * 4,
        "slt_dense_jacobi": [_I, _I, _I] + [_P] * 5 + [_I] + [_P] * 3,
        "slt_dense_power": [_I, _I, _I] + [_P] * 3 + [_F, _F, _I] + [_P] * 4,
    },
    "spmm_kernels": {
        "slt_csr_spmm": [_I] * 5 + [_P] * 7,
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


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


def _lib_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libslt_{source.stem}_{digest}.so"


def build() -> tuple[dict[str, Path], float, str]:
    """Compile every ``csrc/*.cu`` that has no library for its source yet,
    one nvcc per source, all started together.

    Returns ``({source stem: library path}, seconds spent compiling,
    compiler log)``; the seconds are 0.0 and the log is the saved one when
    every library was already built.  A failed build raises with nvcc's
    stderr."""
    paths = {src.stem: _lib_path(src) for src in sorted(CSRC.glob("*.cu"))}
    todo = {stem: path for stem, path in paths.items() if not path.exists()}
    t0 = time.perf_counter()
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for stem, path in todo.items():
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            procs[stem] = (tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC / f"{stem}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        failed = []
        for stem, (tmp, proc) in procs.items():
            out, err = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"nvcc failed (exit {proc.returncode}) on "
                              f"{stem}.cu:\n{err}")
                continue
            todo[stem].with_suffix(".log").write_text(out + err)
            os.replace(tmp, todo[stem])
        if failed:
            raise RuntimeError("\n".join(failed))
    seconds = time.perf_counter() - t0 if todo else 0.0
    logs = (path.with_suffix(".log") for path in paths.values())
    return paths, seconds, "".join(p.read_text() for p in logs if p.exists())


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library built from ``csrc/<name>.cu``; the first
    call builds every source that needs it."""
    with _lock:
        if name not in _libs:
            paths, _, _ = build()
            lib = ctypes.CDLL(str(paths[name]))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = _I
            lib.slt_error_string.argtypes = [_I]
            lib.slt_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def ptr(t):
    """A tensor's device pointer as an int for a ``c_void_p`` argument (None
    for None)."""
    return None if t is None else t.data_ptr()


def stream_of(t) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as an int: the raw
    handle torch's own generated kernels launch on, one C call instead of a
    ``torch.cuda.Stream`` object per launch."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def raise_on(rc: int, name: str, lib: ctypes.CDLL):
    """Raise if a kernel entry point returned a CUDA error."""
    if rc != 0:
        msg = lib.slt_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")
