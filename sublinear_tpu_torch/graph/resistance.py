"""Effective resistance via a grounded-Laplacian solve, as in
``sublinear_tpu/graph/resistance.py``.

Reference: GraphTools.effectiveResistance (src/mcp/tools/graph.ts:125-186):
ground the last node (drop row and column n-1), solve L_g x = e_s - e_t,
resistance = |x_s - x_t|.  The solve is CG (on the ``"csr"`` route the
``cg_step`` chain kernel).
"""
from __future__ import annotations

import numpy as np

from ..errors import InvalidParametersError
from ..matrix import Matrix
from ..solvers.dispatch import solve
from ..types import SolverOptions


def grounded_laplacian(laplacian: Matrix) -> Matrix:
    """Drop the last row/column (graph.ts:263-303)."""
    n = laplacian.shape[0]
    r, c, v = laplacian.csr.to_coo()
    keep = (r < n - 1) & (c < n - 1)
    return Matrix.from_coo(r[keep], c[keep], v[keep], (n - 1, n - 1),
                           device=laplacian.device)


def effective_resistance(
    laplacian: Matrix, source: int, target: int, epsilon: float = 1e-6, max_iterations: int = 1000
) -> dict:
    n = laplacian.shape[0]
    if not (0 <= source < n) or not (0 <= target < n):
        raise InvalidParametersError(f"source/target out of bounds for n={n}")
    if source == target:
        return {"effectiveResistance": 0.0, "voltage": [0.0] * n, "source": source, "target": target}

    Lg = grounded_laplacian(laplacian)
    e = np.zeros(n)
    e[source] = 1.0
    e[target] = -1.0
    eg = e[: n - 1]

    # grounded Laplacians of connected graphs are SPD -> CG
    result = solve(
        Lg, eg,
        SolverOptions(epsilon=epsilon, max_iterations=max_iterations),
        method="conjugate-gradient",
        raise_on_fail=False,
    )
    voltage = np.concatenate([result.solution, [0.0]])
    resistance = float(abs(voltage[source] - voltage[target]))
    return {
        "effectiveResistance": resistance,
        "voltage": voltage.tolist(),
        "source": source,
        "target": target,
        "convergenceInfo": {
            "iterations": result.iterations,
            "residual": result.residual,
            "converged": result.converged,
        },
    }
