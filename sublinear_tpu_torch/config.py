"""Device and dtype configuration.

float32 compute by default, as in the JAX package.  Dense float32 products
run in full float32 (no TF32), so they match the JAX package's
``Precision.HIGHEST`` contractions.
"""
from __future__ import annotations

import os

import numpy as np
import torch

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


def default_dtype() -> torch.dtype:
    return torch.float32


_DTYPE_NAMES = {"float32": torch.float32, "float64": torch.float64}


def to_device(a, dtype: torch.dtype, dev=None) -> torch.Tensor:
    """A host array as a contiguous tensor of ``dtype`` on ``device(dev)``.

    NumPy does the dtype conversion: a torch conversion on the CPU runs on
    torch's intra-op thread pool, whose threads then contend with the solver
    loop's host work (measured on an 8-core H100 host: a warm n=100k solve
    took 10-33 ms with torch converting on 8 threads, 1.4-2.5 ms with NumPy
    converting).  On the CPU the tensor may share ``a``'s memory."""
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    host = np.ascontiguousarray(a, dtype=np_dtype)
    return torch.from_numpy(host).to(device(dev))


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
