"""Device and host memory profiling per solve, as in
``sublinear_tpu/utils/memory_profiler.py``.

Reference: scripts/performance/memory_profiler.py (host snapshots around
each operation).  On a card the numbers come from torch's caching
allocator: the bytes allocated before and after the operation, and the
peak during it (``torch.cuda.reset_peak_memory_stats`` before,
``torch.cuda.max_memory_allocated`` after); tracemalloc gives the host
peak.  On the CPU the device counters stay 0.
"""
from __future__ import annotations

import dataclasses
import gc
import tracemalloc
from contextlib import contextmanager

import torch

from .. import config


@dataclasses.dataclass
class MemoryProfile:
    operation: str
    n: int = 0
    nnz: int = 0
    device_bytes_before: int = 0
    device_bytes_after: int = 0
    device_peak_bytes: int = 0
    device_delta_bytes: int = 0
    host_peak_mb: float = 0.0
    backend: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _device_stats(dev: torch.device) -> tuple:
    """(bytes allocated, peak bytes allocated) on ``dev``; (0, 0) on the
    CPU."""
    if dev.type != "cuda":
        return 0, 0
    torch.cuda.synchronize(dev)
    return torch.cuda.memory_allocated(dev), torch.cuda.max_memory_allocated(dev)


@contextmanager
def profile_memory(operation: str, n: int = 0, nnz: int = 0, device=None):
    """Context manager yielding a MemoryProfile filled on exit."""
    dev = config.device(device)
    gc.collect()
    tracing = tracemalloc.is_tracing()
    if not tracing:
        tracemalloc.start()
    tracemalloc.reset_peak()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    before, _ = _device_stats(dev)
    prof = MemoryProfile(operation=operation, n=n, nnz=nnz,
                         device_bytes_before=before, backend=dev.type)
    try:
        yield prof
    finally:
        after, peak = _device_stats(dev)
        _, host_peak = tracemalloc.get_traced_memory()
        if not tracing:
            tracemalloc.stop()
        prof.device_bytes_after = after
        prof.device_peak_bytes = peak
        prof.device_delta_bytes = after - before
        prof.host_peak_mb = host_peak / 1e6


def profile_solve(matrix, b, options=None, method: str = "auto") -> MemoryProfile:
    """Profile one solve end-to-end (operator build + iteration) on the
    matrix's device."""
    from ..solvers.dispatch import solve
    from ..types import SolverOptions

    options = options or SolverOptions()
    with profile_memory(f"solve[{method}]", n=matrix.shape[0], nnz=matrix.nnz,
                        device=matrix.device) as prof:
        r = solve(matrix, b, options, method=None if method == "auto" else method,
                  raise_on_fail=False)
        prof.operation = f"solve[{r.method}]"
    return prof


def memory_sweep(sizes=(200, 500, 1000), density: float = 0.02, seed: int = 0) -> list:
    """Catalog sweep mirroring the reference profiler's per-size loop."""
    from .. import generate, rhs

    out = []
    for n in sizes:
        A = generate("random-sparse", n, seed=seed, density=density)
        b = rhs(n, seed=seed)
        out.append(profile_solve(A, b).to_dict())
    return out
