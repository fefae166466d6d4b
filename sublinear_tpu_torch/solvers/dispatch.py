"""Top-level ``solve()``: validation, DD gating and adaptive method choice, as
in ``sublinear_tpu/solvers/dispatch.py``.

Every ``Method`` of the JAX package is routed to its port: the Neumann
series, CG, BiCGSTAB, Chebyshev, Jacobi, multicolor Gauss-Seidel and SOR,
the three push directions, random walk, hybrid and BMSSP.  ``ADAPTIVE``
runs what ``select_method`` picks and, when a non-Krylov choice does not
converge, polishes with CG (symmetric) or BiCGSTAB from its iterate, as the
JAX package does.  The E001 gate runs first, exactly as in the JAX package,
so error codes match for every method.
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
            # warm-start a Krylov polish from the failed iterate: CG on a
            # symmetric system, BiCGSTAB otherwise
            x0 = (np.asarray(first.solution)
                  if np.all(np.isfinite(first.solution)) else None)
            polish_m = (
                Method.CG
                if analyze(matrix, estimate_condition=False).is_symmetric
                else Method.BICGSTAB
            )
            polish = dataclasses.replace(options, method=polish_m, x0=x0)
            result = solve(matrix, b, polish, raise_on_fail=raise_on_fail)
            return dataclasses.replace(
                result,
                iterations=result.iterations + first.iterations,
                method=f"adaptive({first.method}->{result.method})",
                compute_time_ms=result.compute_time_ms + first.compute_time_ms,
            )

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
    if m == Method.BICGSTAB:
        from . import cg as _cg

        return _cg.solve_bicgstab(matrix, b, options, raise_on_fail)
    if m == Method.CG:
        from . import cg as _cg

        # CG's theory needs symmetry; an asymmetric system goes to BiCGSTAB
        if analyze(matrix, estimate_condition=False).is_symmetric:
            return _cg.solve_cg(matrix, b, options, raise_on_fail)
        return _cg.solve_bicgstab(matrix, b, options, raise_on_fail)
    if m == Method.CHEBYSHEV:
        from . import chebyshev as _cheb

        return _cheb.solve_chebyshev(matrix, b, options, raise_on_fail)
    if m in (Method.JACOBI, Method.GAUSS_SEIDEL, Method.SOR):
        from . import jacobi as _jacobi

        if m == Method.JACOBI:
            return _jacobi.solve_jacobi(matrix, b, options, raise_on_fail)
        if m == Method.GAUSS_SEIDEL:
            return _jacobi.solve_gauss_seidel(matrix, b, options,
                                              raise_on_fail)
        return _jacobi.solve_sor(matrix, b, options,
                                 raise_on_fail=raise_on_fail)
    if m in (Method.FORWARD_PUSH, Method.BACKWARD_PUSH, Method.BIDIRECTIONAL):
        from . import push as _push

        return _push.solve_push(matrix, b, options, direction=m.value,
                                raise_on_fail=raise_on_fail)
    if m == Method.RANDOM_WALK:
        from . import random_walk as _rw

        return _rw.solve_random_walk(matrix, b, options, raise_on_fail)
    if m == Method.HYBRID:
        from . import hybrid as _hybrid

        return _hybrid.solve_hybrid(matrix, b, options, raise_on_fail)
    if m == Method.BMSSP:
        from . import bmssp as _bmssp

        return _bmssp.solve_bmssp(matrix, b, options, raise_on_fail)
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
