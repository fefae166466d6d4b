"""Checkpoint and warm restart, as in ``sublinear_tpu/utils/checkpoint.py``.

A checkpoint is the iterate of a solve with its right-hand side, method,
residual and iteration count, saved with ``np.savez`` under the JAX
package's keys, so a checkpoint written by either package loads in the
other.  ``resume`` continues any solver from the checkpointed iterate (the
``x0`` warm start of ``solve()``); ``update_rhs`` applies a sparse RHS delta
(reference: src/solver/neumann.rs:436-462, src/types.rs:184-193) and
re-solves from the previous solution.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..matrix import Matrix
from ..types import DeltaUpdate, SolverOptions, SolverResult


@dataclasses.dataclass
class SolverCheckpoint:
    solution: np.ndarray
    rhs: np.ndarray
    method: str
    residual: float
    iterations: int

    def save(self, path: str):
        np.savez(
            path,
            solution=self.solution,
            rhs=self.rhs,
            method=np.asarray(self.method),
            residual=np.asarray(self.residual),
            iterations=np.asarray(self.iterations),
        )

    @classmethod
    def load(cls, path: str) -> "SolverCheckpoint":
        with np.load(path, allow_pickle=False) as z:
            return cls(
                solution=z["solution"],
                rhs=z["rhs"],
                method=str(z["method"]),
                residual=float(z["residual"]),
                iterations=int(z["iterations"]),
            )


def checkpoint_of(result: SolverResult, b) -> SolverCheckpoint:
    return SolverCheckpoint(
        solution=np.asarray(result.solution, dtype=np.float64),
        rhs=np.asarray(b, dtype=np.float64),
        method=result.method,
        residual=result.residual,
        iterations=result.iterations,
    )


def resume(
    matrix: Matrix,
    checkpoint: SolverCheckpoint,
    options: Optional[SolverOptions] = None,
    method: Optional[str] = None,
    b=None,
) -> SolverResult:
    """Continue a solve from a checkpointed iterate (possibly with a new
    RHS).  The result's iterations include the checkpoint's."""
    from ..solvers.dispatch import solve
    from ..types import parse_method

    options = options or SolverOptions()
    options = dataclasses.replace(options, x0=checkpoint.solution)
    rhs = checkpoint.rhs if b is None else np.asarray(b, dtype=np.float64)
    m = method or checkpoint.method
    try:
        m = parse_method(m)
    except ValueError:
        m = "adaptive"  # decorated names like "bmssp(cg-fallback)" re-dispatch
    result = solve(matrix, rhs, options, method=m, raise_on_fail=False)
    result.iterations += checkpoint.iterations
    return result


def update_rhs(
    matrix: Matrix,
    previous: SolverResult,
    delta: DeltaUpdate,
    b_old,
    options: Optional[SolverOptions] = None,
    method: Optional[str] = None,
) -> tuple[SolverResult, np.ndarray]:
    """Incremental solve after a sparse RHS delta: b_new = b_old +
    scatter(delta), warm-started from the previous solution.  Returns
    (result, b_new)."""
    b_new = np.asarray(b_old, dtype=np.float64).copy()
    idx = np.asarray(delta.indices, dtype=np.int64).reshape(-1)
    vals = np.asarray(delta.values, dtype=np.float64).reshape(-1)
    b_new[idx] += vals
    ckpt = checkpoint_of(previous, b_new)
    return resume(matrix, ckpt, options, method=method, b=b_new), b_new
