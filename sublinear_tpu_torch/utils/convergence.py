"""Host-side convergence tracking utilities, a copy of
``sublinear_tpu/utils/convergence.py``.

Reference: ``ConvergenceChecker`` (src/core/utils.ts:219-292, rate tracking
over a residual history) and ``ConvergenceDetector``
(src/convergence/convergence-detector.js:8-200, stagnation and zero-RHS
warnings).  For streaming and serving layers; the solvers' host loops
carry their own convergence checks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass
class ConvergenceInfo:
    converged: bool
    rate: float
    estimated_iterations_remaining: Optional[int]
    stagnated: bool


class ConvergenceChecker:
    def __init__(self, window: int = 10, stagnation_tol: float = 1e-12):
        self.history: list[float] = []
        self.window = window
        self.stagnation_tol = stagnation_tol

    def check(self, residual: float, tolerance: float) -> ConvergenceInfo:
        self.history.append(float(residual))
        h = self.history[-self.window :]
        rate = 1.0
        if len(h) >= 2 and h[0] > 0:
            # geometric mean contraction factor over the window
            rate = (h[-1] / h[0]) ** (1.0 / (len(h) - 1)) if h[-1] > 0 else 0.0
        remaining = None
        if 0 < rate < 1 and residual > tolerance > 0:
            remaining = int(math.ceil(math.log(tolerance / residual) / math.log(rate)))
        stagnated = (
            len(h) >= self.window
            and abs(h[-1] - h[0]) < self.stagnation_tol * max(abs(h[0]), 1.0)
            and residual > tolerance
        )
        return ConvergenceInfo(
            converged=residual <= tolerance,
            rate=rate,
            estimated_iterations_remaining=remaining,
            stagnated=stagnated,
        )

    def reset(self):
        self.history.clear()
