"""Single-entry and functional estimation, the "sublinear query" surface, as
in ``sublinear_tpu/queries/estimate.py``.

Reference semantics:
  - ``SublinearSolver.estimateEntry`` (src/core/solver.ts:550-659): method
    'random-walk'/'monte-carlo' estimates x_row = (A^-1 b)_row by MC walks
    from ``row``; method 'neumann' solves A x = e_col and returns x[row],
    i.e. the INVERSE entry (A^-1)_{row,col}.  Both (asymmetric) semantics
    are kept.
  - ``predict_functional`` (temporal-lead-solver/src/predictor.rs:176-300):
    t^T A^-1 b via budgeted forward push plus a backward correction.

Entry queries are batched: an array of rows is answered by one batch of
lock-step walkers (``solvers/random_walk.py``) or one full solve.  The
pushes run on the matrix's device (on the ``"csr"`` route one ``csr_spmv``
per sweep); the residuals of the functional estimate are host f64
products, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from math import sqrt
from typing import Optional, Sequence

import numpy as np

from ..config import to_host
from ..errors import IndexOutOfBoundsError, InvalidParametersError
from ..matrix import Matrix
from ..solvers import push as _push
from ..solvers.dispatch import solve
from ..solvers.random_walk import walk_estimate
from ..types import SolverOptions


@dataclasses.dataclass
class EntryEstimate:
    """Single-entry estimate with a variance-backed confidence interval
    (reference: src/core/solver.ts:550-659 reports estimate + variance;
    the interval here is the normal-approximation CI at the requested
    confidence level, or a residual-backed deterministic interval for the
    exact methods)."""

    estimate: float
    variance: float
    confidence: float           # CI half-width (legacy field name)
    method: str
    confidence_level: float = 0.95

    @property
    def confidence_interval(self) -> tuple:
        return (self.estimate - self.confidence, self.estimate + self.confidence)

    def to_dict(self) -> dict:
        lo, hi = self.confidence_interval
        return {
            "estimate": self.estimate,
            "variance": self.variance,
            "confidence": self.confidence,
            "confidenceInterval": [lo, hi],
            "confidenceLevel": self.confidence_level,
            "method": self.method,
        }


def _check_index(i: int, n: int, what: str):
    if not (0 <= i < n):
        raise IndexOutOfBoundsError(
            f"{what} index {i} out of bounds. Valid range: 0-{n - 1}", {"index": i, "n": n}
        )


def estimate_entry(
    matrix: Matrix,
    b,
    row: int,
    column: int = 0,
    method: str = "random-walk",
    epsilon: float = 1e-6,
    confidence: float = 0.95,
    options: Optional[SolverOptions] = None,
) -> EntryEstimate:
    n = matrix.shape[0]
    _check_index(row, n, "Row")
    _check_index(column, matrix.shape[1], "Column")
    options = options or SolverOptions(epsilon=max(epsilon, 1e-4))

    if method in ("random-walk", "monte-carlo"):
        est, var, _ = walk_estimate(matrix, b, [row], options)
        w = max(1, int(options.num_walks or 100))
        # normal-approx CI half-width at requested confidence
        z = {0.9: 1.645, 0.95: 1.96, 0.99: 2.576}.get(round(confidence, 2), 1.96)
        half = z * sqrt(max(var[0], 0.0) / w)
        return EntryEstimate(float(est[0]), float(var[0]), float(half), method,
                             confidence_level=confidence)

    if method == "neumann":
        # reference solves A x = e_col and reads x[row] -> (A^-1)_{row,col}
        e = np.zeros(n)
        e[column] = 1.0
        r = solve(matrix, e, options, method="neumann", raise_on_fail=False)
        # deterministic half-width from the solve's error bound when available
        half = float(r.error_bounds.upper_bound) if r.error_bounds else 0.0
        return EntryEstimate(float(r.solution[row]), 0.0, half, "neumann",
                             confidence_level=1.0)

    if method == "backward-push":
        # adjoint identity: x_row = y . b where A^T y = e_row
        e = np.zeros(n)
        e[row] = 1.0
        y, k, res = _push.adjoint_solve(matrix, e, options)
        y = to_host(y, np.float64)
        bb = np.asarray(b, dtype=np.float64)
        # residual of the adjoint solve bounds the estimate error by
        # ||r|| * ||b|| / alpha (Varah) when A is strictly DD
        alpha = matrix.dominance_gap()
        half = float(res) * float(np.linalg.norm(bb)) / alpha if alpha > 0 else float(res)
        return EntryEstimate(float(y @ bb), 0.0, half, method, confidence_level=1.0)

    raise InvalidParametersError(f"Unknown estimation method: {method}")


def estimate_entries(
    matrix: Matrix, b, rows: Sequence[int], method: str = "random-walk",
    options: Optional[SolverOptions] = None,
) -> np.ndarray:
    """Batched x[rows] estimates: one batch of walkers for all rows (the
    reference's 10k-entry MC row), or one full solve."""
    n = matrix.shape[0]
    rows = np.asarray(rows, dtype=np.int64).reshape(-1)
    if rows.size and (rows.min() < 0 or rows.max() >= n):
        raise IndexOutOfBoundsError("row indices out of bounds")
    options = options or SolverOptions(epsilon=1e-3)
    if method in ("random-walk", "monte-carlo"):
        est, _, _ = walk_estimate(matrix, b, rows, options)
        return est
    # deterministic: one full solve serves every row
    r = solve(matrix, b, options, raise_on_fail=False)
    return r.solution[rows]


def estimate_functional(
    matrix: Matrix,
    b,
    t,
    options: Optional[SolverOptions] = None,
    budget: Optional[int] = None,
) -> dict:
    """Estimate t^T A^-1 b with a bidirectional push estimator.

    Forward push on b gives (x~, r); adjoint push on t gives (y~, s).  Then
        t^T x = t^T x~ + y~^T r + s^T A^-1 r
    and we return t^T x~ + y~^T r, whose error is bounded by the bilinear
    residual term — the budgeted scheme of predictor.rs:176-300 re-expressed
    as two bounded frontier pushes.
    """
    options = options or SolverOptions()
    n = matrix.shape[0]
    t_vec = np.asarray(t, dtype=np.float64).reshape(-1)
    b_vec = np.asarray(b, dtype=np.float64).reshape(-1)
    if t_vec.size != n or b_vec.size != n:
        raise InvalidParametersError("t and b must have length n")

    sweeps = budget if budget is not None else max(options.max_iterations // 8, 16)
    fwd_opts = dataclasses.replace(options, max_iterations=sweeps)

    r_fwd = _push.solve_push(matrix, b_vec, fwd_opts, raise_on_fail=False)
    x_tilde = r_fwd.solution
    residual = b_vec - matrix.csr.matvec(x_tilde)

    y_dev, k_b, res_b = _push.adjoint_solve(matrix, t_vec, fwd_opts)
    y_tilde = to_host(y_dev, np.float64)

    estimate = float(t_vec @ x_tilde + y_tilde @ residual)
    # error bound: |s^T A^-1 r| <= ||s|| ||r|| / (min diag gap) — report raw norms
    s_norm = float(np.linalg.norm(t_vec - matrix.T_csr().matvec(y_tilde)))
    r_norm = float(np.linalg.norm(residual))
    return {
        "estimate": estimate,
        "forwardResidual": r_norm,
        "backwardResidual": s_norm,
        "errorBound": s_norm * r_norm,
        "sweeps": {"forward": r_fwd.iterations, "backward": k_b},
    }
