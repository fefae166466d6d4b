"""Device and dtype configuration, and the port's host-device boundary.

float32 compute by default, as in the JAX package.  Dense float32 products
run in full float32 (no TF32), so they match the JAX package's
``Precision.HIGHEST`` contractions.

``to_device`` puts a host array on the device (``copy_to_device`` into a
tensor already there), ``to_host`` reads a tensor back and ``host_float``
reads one number: the library's crossings go through them, so the tracing
counters (``h2d_bytes``, ``d2h_bytes``, ``host_syncs``) see every one.  ``parallel/sharded.py`` counts its own
batch copies, and ``models/`` and ``interfaces/`` read back on their own.
The port pads no domain: a vector of an (n, m) operator has n or m
entries.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import tracing

torch.backends.cuda.matmul.allow_tf32 = False


def device(explicit=None) -> torch.device:
    """Resolve the compute device: an explicit argument, then the
    ``SLT_TORCH_DEVICE`` environment variable, then ``cuda``.

    The CPU is taken only when one of the first two asks for it: with
    neither set and no card present this raises, so a machine whose card is
    missing never solves on the CPU without saying so."""
    if explicit is not None:
        return torch.device(explicit)
    env = os.environ.get("SLT_TORCH_DEVICE")
    if env:
        return torch.device(env)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is available (torch.cuda.is_available() is False); "
            "to run on the CPU ask for it: Matrix(..., device='cpu') or "
            "SLT_TORCH_DEVICE=cpu")
    return torch.device("cuda")


# configure_platform's names: the JAX package's "gpu" is the card here
_PLATFORMS = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}


def configure_platform(platform: str | None = None) -> None:
    """Select the device of this process: ``cpu``, or ``cuda`` (``gpu``).

    Priority: the argument, then the ``SLT_PLATFORM`` environment variable,
    then nothing, which leaves ``device()``'s own choice (the card) alone.
    The choice is made by setting ``SLT_TORCH_DEVICE``, so it holds for
    every later ``device()`` call of this process and for the processes it
    starts.  The counterpart of ``sublinear_tpu/config.py::
    configure_platform``, which the CLI, MCP and HTTP entry points call."""
    p = platform or os.environ.get("SLT_PLATFORM")
    if not p:
        return
    if p not in _PLATFORMS:
        from .errors import InvalidParametersError

        raise InvalidParametersError(
            f"unknown platform {p!r}: expected one of {sorted(_PLATFORMS)}",
            {"platform": p})
    os.environ["SLT_TORCH_DEVICE"] = _PLATFORMS[p]


def default_dtype() -> torch.dtype:
    return torch.float32


_DTYPE_NAMES = {"float32": torch.float32, "float64": torch.float64}


def to_device(a, dtype: torch.dtype, dev=None) -> torch.Tensor:
    """A host array as a contiguous tensor of ``dtype`` on ``device(dev)``.

    NumPy does the dtype conversion: a torch conversion on the CPU runs on
    torch's intra-op thread pool, whose threads then contend with the solver
    loop's host work (measured on an 8-core H100 host: a warm n=100k solve
    took 10-33 ms with torch converting on 8 threads, 1.4-2.5 ms with NumPy
    converting).  On the CPU the tensor may share ``a``'s memory.  Span
    ``slt.to_device``; counts the tensor's bytes in ``h2d_bytes``."""
    with tracing.span("slt.to_device"):
        t = torch.from_numpy(_host_array(a, dtype)).to(device(dev))
        tracing.count("h2d_bytes", t.numel() * t.element_size())
        return t


def copy_to_device(a, out: torch.Tensor) -> torch.Tensor:
    """``to_device`` into the existing tensor ``out``: the host array ``a``
    (``out.numel()`` numbers), converted by NumPy to ``out``'s dtype, is
    copied into ``out``, and ``out`` is returned.  Span ``slt.to_device``;
    counts ``out``'s bytes in ``h2d_bytes``."""
    with tracing.span("slt.to_device"):
        out.copy_(torch.from_numpy(_host_array(a, out.dtype)).reshape(out.shape))
        tracing.count("h2d_bytes", out.numel() * out.element_size())
        return out


def _host_array(a, dtype: torch.dtype) -> np.ndarray:
    """``a`` as a contiguous NumPy array of the NumPy twin of ``dtype``."""
    return np.ascontiguousarray(a, dtype=torch.empty(0, dtype=dtype).numpy().dtype)


def to_host(t: torch.Tensor, dtype=None) -> np.ndarray:
    """A tensor as a NumPy array on the host, converted to ``dtype`` (a
    NumPy dtype) where given: the host waits for the device's work on
    ``t``.  From a CUDA device the card converts, and the array lands in a
    pinned tensor of torch's caching host allocator, whose ``.numpy()``
    view this returns: the view holds the tensor, and the allocator reuses
    the block only once the view and every array made from it are gone.
    On the CPU NumPy converts, and the array may share ``t``'s memory when
    no ``dtype`` is given.  Span ``slt.to_host``; counts one
    ``host_syncs``, the bytes read in ``d2h_bytes`` and, pinned, in
    ``pinned_d2h_bytes``."""
    with tracing.span("slt.to_host"):
        t = t.detach()
        if t.is_cuda:
            if dtype is not None:
                t = t.to(torch.from_numpy(np.empty(0, dtype)).dtype)
            nbytes = t.numel() * t.element_size()
            tracing.count_read(nbytes)
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)
            tracing.count("pinned_d2h_bytes", nbytes)
            return host.numpy()
        tracing.count_read(t.numel() * t.element_size())
        host = t.cpu().numpy()
        return host if dtype is None else host.astype(dtype)


def host_float(t: torch.Tensor) -> float:
    """``float(t)`` of a one-element tensor: the host waits for the device's
    work on ``t``.  Counts one ``host_syncs`` and its bytes in
    ``d2h_bytes``; no span (its time is the device work it waits for)."""
    tracing.count_read(t.element_size())
    return float(t)


def host_pair(a: torch.Tensor, b: torch.Tensor) -> list:
    """``[float(a), float(b)]`` of two 0-d tensors of one dtype in one
    blocking read.  Counts one ``host_syncs`` and its bytes in
    ``d2h_bytes``; no span, as ``host_float``."""
    pair = torch.stack((a, b))
    tracing.count_read(pair.numel() * pair.element_size())
    return pair.tolist()


def resolve_dtype(dtype) -> torch.dtype:
    if dtype is None:
        return default_dtype()
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(getattr(dtype, "name", dtype)).lower()
    if name not in _DTYPE_NAMES:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return _DTYPE_NAMES[name]


# Below this size the solver keeps A dense and multiplies with torch.matmul
# (the same threshold and environment variable as the JAX package, so both
# packages route a given matrix the same way).
DENSE_THRESHOLD = int(os.environ.get("SLT_DENSE_THRESHOLD", "10240"))
