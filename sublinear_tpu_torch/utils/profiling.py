"""Structured per-solve observability records, as in
``sublinear_tpu/utils/profiling.py``.

Reference: ``SolverStats``/``ProfileData`` (src/types.rs:88-251) and
``PerformanceMonitor`` (src/core/utils.ts:173-218), in the form
{method, n, nnz, iters, residual, wall, nnz/s, chips}.  ``backend`` is the
device type the matrix lives on (``"cuda"``, or ``"cpu"`` when the CPU was
asked for) and ``chips`` the number of cards torch sees (1 on the CPU).
``memory_info`` reads the caching allocator's counters
(``torch.cuda.memory_stats``) and the card's free and total memory
(``torch.cuda.mem_get_info``); a failed read raises.  ``device_trace``
wraps ``torch.profiler`` and writes a chrome trace, with the port's spans
and counters (``tracing.py``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import torch

from .. import config, tracing


@dataclasses.dataclass
class SolveRecord:
    method: str
    n: int
    nnz: int
    iterations: int
    residual: float
    converged: bool
    wall_ms: float
    nnz_per_second: float
    matvec_count: int
    backend: str
    chips: int
    timestamp: float

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def _backend(device) -> tuple:
    """(backend name, chips) of ``device``: ("cuda", cards torch sees) or
    ("cpu", 1)."""
    dev = config.device(device)
    if dev.type == "cuda":
        return "cuda", torch.cuda.device_count()
    return dev.type, 1


def record_solve(matrix, result, matvec_count: Optional[int] = None) -> SolveRecord:
    mv = matvec_count if matvec_count is not None else max(result.iterations, 1)
    secs = max(result.compute_time_ms / 1e3, 1e-12)
    backend, chips = _backend(getattr(matrix, "device", None))
    return SolveRecord(
        method=result.method,
        n=matrix.shape[0],
        nnz=matrix.nnz,
        iterations=result.iterations,
        residual=result.residual,
        converged=result.converged,
        wall_ms=result.compute_time_ms,
        nnz_per_second=matrix.nnz * mv / secs,
        matvec_count=mv,
        backend=backend,
        chips=chips,
        timestamp=time.time(),
    )


def memory_info() -> dict:
    """Device and host memory report (reference: MemoryInfo,
    src/types.rs:213+): for each card torch sees, the allocator's bytes in
    use and peak and the card's total memory; on the CPU one entry with no
    device counters."""
    dev = config.device()
    devices = []
    if dev.type == "cuda":
        for i in range(torch.cuda.device_count()):
            s = torch.cuda.memory_stats(i)
            _, total = torch.cuda.mem_get_info(i)
            devices.append({
                "id": i, "platform": "cuda",
                "bytesInUse": s.get("allocated_bytes.all.current", 0),
                "bytesLimit": total,
                "peakBytesInUse": s.get("allocated_bytes.all.peak", 0),
            })
    else:
        devices.append({"id": 0, "platform": dev.type})
    try:
        import resource

        host_rss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    except ImportError:  # no ``resource`` module off POSIX
        host_rss_kb = None
    return {"devices": devices, "hostPeakRssKb": host_rss_kb}


class device_trace:
    """torch.profiler trace of a block of work, written as a chrome trace
    (``trace.json``) into ``log_dir``; the card's kernels are traced when
    the device is a card.

        with device_trace("traces/solve") as t:
            slt.solve(A, b)
        t.counters  # also in traces/solve/counters.json

    The trace holds the port's spans (``slt.solve``, ``slt.loop``,
    ``slt.to_device``, ...: ``tracing.py``) on the clock of the device's
    kernels and copies; open ``trace.json`` in Perfetto or
    ``chrome://tracing``.  ``counters.json`` holds the port's counters over
    the block (``h2d_bytes``, ``d2h_bytes``, ``host_syncs``), which start
    from 0 on entry.
    """

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.device = config.device()
        self.path = os.path.join(log_dir, "trace.json")
        self.counters_path = os.path.join(log_dir, "counters.json")
        self.counters: dict = {}

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        tracing.reset()

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.__exit__(*exc)
        self.counters = tracing.counters()
        os.makedirs(self.log_dir, exist_ok=True)
        self._prof.export_chrome_trace(self.path)
        with open(self.counters_path, "w") as f:
            json.dump(self.counters, f, indent=1, sort_keys=True)
        return False


class ProfileLog:
    """Append-only JSONL log of SolveRecords (observability sink)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.records: list[SolveRecord] = []

    def add(self, matrix, result, matvec_count: Optional[int] = None) -> SolveRecord:
        rec = record_solve(matrix, result, matvec_count)
        self.records.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(rec.to_json() + "\n")
        return rec
