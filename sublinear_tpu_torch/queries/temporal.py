"""Temporal-lead prediction: "compute the functional before light arrives",
as in ``sublinear_tpu/queries/temporal.py``.

Reference: the temporal-lead-solver crate (src/{physics,predictor,solver}.rs),
its JS shim (index.js) and the MCP temporal tools
(src/mcp/tools/temporal.ts:134-347).

The physics bookkeeping is kept as it is (distance / c against the measured
compute time); the compute path is the port's ``solve()``.  It returns a
host array, so the ``perf_counter`` timing of a solve includes its device
work.  The validation system (tridiagonal 4 / -1) takes the DIA route.
"""
from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np

from ..generate import tridiagonal
from ..matrix import Matrix
from ..solvers.dispatch import solve
from ..types import SolverOptions

SPEED_OF_LIGHT_MPS = 299_792_458.0

# scenario distances (temporal.ts:234-260, physics.rs:62)
SCENARIOS = {
    "trading": {
        "name": "High-Frequency Trading",
        "route": "Tokyo → New York",
        "distanceKm": 10_900,
        "context": "Financial markets arbitrage",
    },
    "satellite": {
        "name": "Satellite Communication",
        "route": "Ground → GEO Satellite",
        "distanceKm": 35_786,
        "context": "Geostationary orbit communication",
    },
    "network": {
        "name": "Global Network Routing",
        "route": "London → Sydney",
        "distanceKm": 16_983,
        "context": "Intercontinental packet routing",
    },
}


def light_travel_ms(distance_km: float) -> float:
    return (distance_km * 1000.0) / (SPEED_OF_LIGHT_MPS / 1000.0)


def predict_with_temporal_advantage(
    matrix, vector, distance_km: float = 10_900, options: Optional[SolverOptions] = None
) -> dict:
    """Solve (sublinear budgeted) and report temporal advantage
    (index.js:15-34 semantics, real solver underneath)."""
    if not isinstance(matrix, Matrix):
        matrix = Matrix.from_dict(matrix) if isinstance(matrix, dict) else Matrix.from_dense(np.asarray(matrix))
    vector = np.asarray(vector, dtype=np.float64).reshape(-1)
    n = vector.size
    options = options or SolverOptions(max_iterations=max(int(math.log2(max(n, 2))) + 1, 20))

    # warm up first (operator packing, analysis and kernel builds are
    # one-time costs), so the timed solve measures compute, as the
    # reference's always-warm JS runtime does
    solve(matrix, vector, options, raise_on_fail=False)
    t0 = time.perf_counter()
    result = solve(matrix, vector, options, raise_on_fail=False)
    compute_ms = (time.perf_counter() - t0) * 1e3

    light_ms = light_travel_ms(distance_km)
    advantage = light_ms - compute_ms
    velocity_ratio = (distance_km * 1000.0) / max(compute_ms / 1e3, 1e-12) / SPEED_OF_LIGHT_MPS
    query_count = math.sqrt(n) + 100  # reference's O(sqrt n) bookkeeping (index.js:32)

    return {
        "solution": result.solution.tolist(),
        "computeTimeMs": compute_ms,
        "lightTravelTimeMs": light_ms,
        "temporalAdvantageMs": advantage,
        "effectiveVelocity": f"{velocity_ratio:.0f}× speed of light",
        "effectiveVelocityRatio": velocity_ratio,
        "queryCount": query_count,
        "sublinear": query_count < n / 2,
        "converged": result.converged,
        "residual": result.residual,
        "summary": (
            f"Computed solution {advantage:.1f}ms before light could travel {distance_km}km"
        ),
    }


def validate_temporal_advantage(size: int = 1000, distance_km: float = 10_900) -> dict:
    """Tridiagonal 4/-1 validation system (index.js:78-101)."""
    A = Matrix(tridiagonal(size).csr.add_diagonal(2.0))  # diag 4, off -1
    b = np.ones(size)
    result = predict_with_temporal_advantage(A, b, distance_km)
    return {
        "matrixSize": size,
        "computeTimeMs": result["computeTimeMs"],
        "lightTravelTimeMs": result["lightTravelTimeMs"],
        "temporalAdvantageMs": result["temporalAdvantageMs"],
        "effectiveVelocity": result["effectiveVelocity"],
        "queryComplexity": f"O(√n) = {result['queryCount']:.0f} queries",
        "valid": result["temporalAdvantageMs"] > 0,
        "converged": result["converged"],
    }


def calculate_light_travel(distance_km: float, matrix_size: int = 1000) -> dict:
    """temporal.ts:196-230 semantics."""
    light_ms = light_travel_ms(distance_km)
    est_compute = math.log2(max(matrix_size, 2)) * 0.1
    return {
        "distance": {"km": distance_km, "miles": distance_km * 0.621371},
        "lightTravelTime": {"ms": light_ms, "seconds": light_ms / 1e3},
        "estimatedComputeTime": {"ms": est_compute, "seconds": est_compute / 1e3},
        "temporalAdvantage": {
            "ms": light_ms - est_compute,
            "ratio": light_ms / est_compute if est_compute > 0 else float("inf"),
        },
        "feasible": est_compute < light_ms,
        "summary": f"Light takes {light_ms:.1f}ms, computation takes {est_compute:.3f}ms",
    }


def prove_temporal_lead(size: int = 1000, distance_km: float = 10_900, epsilon: float = 1e-6) -> dict:
    """Structured temporal-lead certificate.

    Parity: ``TheoremProver::prove_temporal_lead_theorem``
    (temporal-lead-solver/src/validation.rs:12-278).  The
    reference emits hardcoded proof steps; here every step is *computed*: the
    light bound from the distance, the compute bound from the measured solve,
    and the query-count bound from the dominance parameters.
    """
    import math

    from ..analysis import analyze
    from ..generate import tridiagonal
    from ..matrix import Matrix

    A = Matrix(tridiagonal(size).csr.add_diagonal(2.0))
    a = analyze(A)
    rho = float(a.spectral_radius_estimate or 0.5)
    # iterations to epsilon under the Neumann contraction
    iters_bound = math.ceil(math.log(max(epsilon, 1e-300)) / math.log(max(rho, 1e-9)))
    validation = validate_temporal_advantage(size, distance_km)

    steps = [
        {
            "step": 1,
            "claim": f"Light needs t_light = d/c = {validation['lightTravelTimeMs']:.3f} ms "
                     f"to travel {distance_km} km",
            "basis": "special relativity (no signal outpaces c)",
        },
        {
            "step": 2,
            "claim": f"The system is diagonally dominant with Jacobi spectral radius "
                     f"rho = {rho:.3f} < 1",
            "basis": "Gershgorin bound from the dominance analysis",
        },
        {
            "step": 3,
            "claim": f"Truncated Neumann iteration reaches epsilon={epsilon:g} in at most "
                     f"{iters_bound} iterations (rho^k decay)",
            "basis": "geometric series tail bound",
        },
        {
            "step": 4,
            "claim": f"Measured solve time t_compute = {validation['computeTimeMs']:.3f} ms",
            "basis": "wall-clock measurement on this hardware",
        },
        {
            "step": 5,
            "claim": (
                f"t_compute < t_light with lead {validation['temporalAdvantageMs']:.3f} ms"
                if validation["valid"]
                else "t_compute >= t_light: no lead at this size/distance"
            ),
            "basis": "steps 1 and 4",
        },
    ]
    return {
        "theorem": "temporal computational lead (locally-available inputs)",
        "proved": bool(validation["valid"]),
        "steps": steps,
        "caveat": (
            "The 'lead' compares local computation against light-transit of remote "
            "data; it does not transmit information faster than light."
        ),
        "parameters": {"size": size, "distanceKm": distance_km, "epsilon": epsilon,
                       "spectralRadius": rho, "iterationBound": iters_bound},
    }


def demonstrate_temporal_lead(scenario: str = "trading", custom_distance: Optional[float] = None, size: int = 1000) -> dict:
    sc = SCENARIOS.get(scenario, SCENARIOS["trading"]).copy()
    if custom_distance is not None:
        sc["distanceKm"] = custom_distance
    validation = validate_temporal_advantage(size, sc["distanceKm"])
    return {
        "scenario": sc,
        "demonstration": validation,
        "interpretation": (
            "Temporal lead achieved: the functional was computed before a "
            "light-speed signal could deliver the inputs"
            if validation["valid"]
            else "No temporal lead at this size/distance"
        ),
    }
