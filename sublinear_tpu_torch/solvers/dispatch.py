"""Top-level ``solve()``: validation, DD gating and adaptive method choice, as
in ``sublinear_tpu/solvers/dispatch.py``.

Of the solver family, the Neumann series is ported.  ``ADAPTIVE`` runs when
``select_method`` picks Neumann and it converges.  Every other method, and
the adaptive polish to CG/BiCGSTAB, raises ``NotImplementedError`` naming
the ROADMAP item that ports it.  The E001 gate runs first, exactly as in the
JAX package, so error codes match for every method.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..analysis import analyze
from ..errors import (
    DimensionMismatchError,
    InvalidMatrixError,
    NotDiagonallyDominantError,
)
from ..matrix import Matrix
from ..types import Method, SolverOptions, SolverResult, parse_method

# methods whose convergence theory requires diagonal dominance — the
# reference rejects non-DD inputs with E001 for these (solver.ts:69-76)
_DD_REQUIRED = {
    Method.NEUMANN,
    Method.FORWARD_PUSH,
    Method.BACKWARD_PUSH,
    Method.BIDIRECTIONAL,
    Method.RANDOM_WALK,
    Method.JACOBI,
    Method.CHEBYSHEV,
    Method.HYBRID,
}

_ROADMAP_ITEM = {
    Method.CG: "queue 1, item 3",
    Method.BICGSTAB: "queue 1, item 3",
    Method.JACOBI: "queue 1, item 5",
    Method.GAUSS_SEIDEL: "queue 1, item 5",
    Method.SOR: "queue 1, item 5",
    Method.CHEBYSHEV: "queue 1, item 5",
    Method.FORWARD_PUSH: "queue 1, item 6",
    Method.BACKWARD_PUSH: "queue 1, item 6",
    Method.BIDIRECTIONAL: "queue 1, item 6",
    Method.RANDOM_WALK: "queue 1, item 6",
    Method.HYBRID: "queue 1, item 6",
    Method.BMSSP: "queue 1, item 6",
}


def _not_ported(m: Method, what: str = "method") -> NotImplementedError:
    return NotImplementedError(
        f"{what} '{m.value}' is not ported yet (ROADMAP {_ROADMAP_ITEM[m]})")


def _validate(matrix: Matrix, b) -> np.ndarray:
    if not isinstance(matrix, Matrix):
        matrix = Matrix.from_dict(matrix) if isinstance(matrix, dict) else Matrix.from_dense(matrix)
    if not matrix.is_square():
        raise InvalidMatrixError(f"matrix must be square, got {matrix.shape}")
    b = np.asarray(b, dtype=np.float64).reshape(-1)
    if b.size != matrix.shape[0]:
        raise DimensionMismatchError(
            f"RHS length {b.size} != matrix rows {matrix.shape[0]}"
        )
    return b


def select_method(matrix: Matrix, b: Optional[np.ndarray] = None) -> Method:
    """Adaptive method selection from matrix structure."""
    a = analyze(matrix, estimate_condition=False)
    n = matrix.shape[0]
    if not a.is_diagonally_dominant:
        return Method.CG if a.is_symmetric else Method.BICGSTAB
    if a.is_symmetric:
        if a.dominance_strength > 0.3:
            return Method.NEUMANN
        if (a.spectral_radius_estimate or 0) > 0.7:
            return Method.CHEBYSHEV
        return Method.CG
    if b is not None and np.count_nonzero(b) <= max(1, n // 100):
        return Method.FORWARD_PUSH  # sparse RHS: push touches few coordinates
    return Method.NEUMANN if a.dominance_strength > 0.3 else Method.CG


def solve(
    matrix,
    b,
    options: Optional[SolverOptions] = None,
    method: Optional[str] = None,
    raise_on_fail: bool = True,
    **option_overrides,
) -> SolverResult:
    """Solve A x = b.  ``method`` overrides ``options.method``."""
    if isinstance(matrix, dict):
        matrix = Matrix.from_dict(matrix)
    elif not isinstance(matrix, Matrix):
        matrix = Matrix.from_dense(np.asarray(matrix))
    options = options or SolverOptions()
    if option_overrides:
        options = dataclasses.replace(options, **option_overrides)
    if method is not None:
        options.method = parse_method(method)

    b = _validate(matrix, b)
    m = options.method
    if m == Method.ADAPTIVE:
        m = select_method(matrix, b)
        if m not in (Method.CG, Method.BICGSTAB, Method.BMSSP):
            first = solve(
                matrix, b, dataclasses.replace(options, method=m), raise_on_fail=False
            )
            if first.converged:
                return first
            # the JAX package polishes with a Krylov method from here
            polish_m = (
                Method.CG
                if analyze(matrix, estimate_condition=False).is_symmetric
                else Method.BICGSTAB
            )
            raise _not_ported(polish_m, "adaptive polish with")

    if m in _DD_REQUIRED:
        a = analyze(matrix, estimate_condition=False)
        if not a.is_diagonally_dominant:
            raise NotDiagonallyDominantError(
                "Matrix is not diagonally dominant; sublinear methods require "
                "diagonal dominance. Use method='conjugate-gradient' or 'bmssp'.",
                {"dominanceStrength": a.dominance_strength},
            )

    if options.timeout is not None:
        return _solve_with_timeout(matrix, b, options, m, raise_on_fail)

    if m == Method.NEUMANN:
        from . import neumann as _neumann

        return _neumann.solve_neumann(matrix, b, options, raise_on_fail)
    if m in _ROADMAP_ITEM:
        raise _not_ported(m)
    from ..errors import InvalidParametersError

    raise InvalidParametersError(f"Unknown method: {m}")


def _solve_with_timeout(matrix, b, options, m, raise_on_fail):
    """Wall-clock timeout enforcement (reference: TimeoutController,
    src/core/utils.ts:293, error E004).  The solve runs in warm-restarted
    chunks with a host deadline check between chunks."""
    import time

    from ..errors import TimeoutError_
    from . import base

    deadline = time.perf_counter() + float(options.timeout)
    chunk = max(options.check_every * 10, 50)
    x = options.x0
    total = 0
    result = None
    while total < options.max_iterations:
        step_opts = dataclasses.replace(
            options, timeout=None,
            max_iterations=min(chunk, options.max_iterations - total), x0=x,
        )
        result = solve(matrix, b, step_opts, method=m, raise_on_fail=False)
        total += max(result.iterations, 1)
        x = result.solution
        if result.converged:
            break
        if time.perf_counter() > deadline:
            if raise_on_fail:
                raise TimeoutError_(
                    f"Solve exceeded timeout of {options.timeout}s after {total} iterations",
                    {"iterations": total, "residual": result.residual},
                )
            break
    result.iterations = total
    threshold = base.threshold_for(b, options)
    return base.check_outcome(result, threshold, options, raise_on_fail)
