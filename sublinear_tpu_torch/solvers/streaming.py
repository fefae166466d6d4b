"""Streaming solve: per-chunk iterate snapshots, live RHS deltas and
in-stream verification, as in ``sublinear_tpu/solvers/streaming.py``.

The solve runs ``chunk_iters`` iterations per ``solve()`` call,
warm-restarted from the previous iterate, and the host yields a
``SolutionChunk`` between calls.  Between calls the session polls its
``StreamControl`` for queued ``DeltaUpdate``s: the RHS changes in place, the
iterate carries over, and the stream keeps running toward the new fixed
point (a live ``update_rhs``, without a session restart).  Every
``verify_every`` chunks a random-probe residual check on sampled rows rides
the chunk as a verification event.  These are host loops over the port's
``solve()``, copied from the JAX package.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Iterator, Optional

import numpy as np

from ..matrix import Matrix
from ..types import DeltaUpdate, SolutionChunk, SolverOptions
from . import base
from .dispatch import solve


class StreamControl:
    """Thread-safe mailbox for a LIVE streaming session: other threads (WS
    handlers, schedulers) queue sparse RHS deltas; the streaming loop drains
    them between chunk dispatches."""

    def __init__(self):
        self._lock = threading.Lock()
        self._deltas: list[DeltaUpdate] = []

    def push_delta(self, indices, values):
        d = DeltaUpdate(np.asarray(indices, np.int64).reshape(-1),
                        np.asarray(values, np.float64).reshape(-1))
        with self._lock:
            self._deltas.append(d)
        return d

    def pop_deltas(self) -> list:
        with self._lock:
            out, self._deltas = self._deltas, []
        return out

    def peek_pending(self) -> bool:
        with self._lock:
            return bool(self._deltas)


def _probe_verify(matrix: Matrix, x, b, probes: int, tolerance: float,
                  seed: int) -> dict:
    """Random-probe residual check on sampled rows: the largest |A x - b|
    over ``probes`` rows drawn with ``seed``, against ``tolerance`` times
    max |b|."""
    n = matrix.shape[0]
    rng = np.random.default_rng(seed)
    rows = rng.choice(n, size=min(int(probes), n), replace=False)
    r = matrix.csr.matvec(np.asarray(x, np.float64)) - np.asarray(b, np.float64)
    max_err = float(np.abs(r[rows]).max()) if rows.size else 0.0
    scale = float(np.abs(np.asarray(b)).max()) or 1.0
    return {
        "verified": bool(max_err <= tolerance * scale),
        "max_error": max_err,
        "probe_count": int(rows.size),
        "tolerance": float(tolerance),
    }


def streaming_solve(
    matrix: Matrix,
    b,
    options: Optional[SolverOptions] = None,
    method: str = "conjugate-gradient",
    chunk_iters: int = 10,
    include_solution: bool = False,
    control: Optional[StreamControl] = None,
    verify_every: int = 0,
    verify_probes: int = 16,
    verify_tolerance: float = 1e-4,
) -> Iterator[SolutionChunk]:
    """Yield SolutionChunk after every ``chunk_iters`` iterations.

    ``control``: drain queued DeltaUpdates between chunks (live update_rhs).
    ``verify_every``: emit a random-probe verification event on every k-th
    chunk (and always on the final one)."""
    options = options or SolverOptions()
    b = np.asarray(b, dtype=np.float64).copy()
    threshold = base.threshold_for(b, options)
    t0 = time.perf_counter()
    x = None
    total_iters = 0
    chunk_idx = 0
    rhs_version = 0
    budget = options.max_iterations
    while budget > 0:
        if control is not None:
            deltas = control.pop_deltas()
            if deltas:
                for d in deltas:
                    b[d.indices] += d.values
                rhs_version += len(deltas)
                threshold = base.threshold_for(b, options)
                budget = options.max_iterations  # fresh budget for the new b
        step_opts = dataclasses.replace(
            options, max_iterations=min(chunk_iters, budget), x0=x, check_every=1
        )
        result = solve(matrix, b, step_opts, method=method, raise_on_fail=False)
        x = result.solution
        total_iters += result.iterations
        budget -= max(result.iterations, 1)
        chunk_idx += 1
        converged = bool(result.residual <= threshold * 1.0000001)
        verification = None
        if verify_every and (chunk_idx % verify_every == 0 or converged):
            verification = _probe_verify(matrix, x, b, verify_probes,
                                         verify_tolerance,
                                         seed=(options.seed or 0) + chunk_idx)
        yield SolutionChunk(
            iteration=total_iters,
            residual=result.residual,
            converged=converged,
            solution=np.asarray(x) if (include_solution or converged) else None,
            timestamp_ms=(time.perf_counter() - t0) * 1e3,
            verification=verification,
            rhs_version=rhs_version,
        )
        if converged or result.iterations == 0:
            # a live session continues only if an update is already queued
            if control is None or not control.peek_pending():
                return
