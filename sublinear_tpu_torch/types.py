"""Core option/result types, as in ``sublinear_tpu/types.py``.

Differences from the JAX package:
  - ``SolverOptions.dtype`` holds a ``torch.dtype`` (None means float32, see
    ``config.resolve_dtype``);
  - the streaming types (``SolutionChunk``, ``DeltaUpdate``) wait for the
    streaming solvers' port.

Convergence defaults to the *relative* l2 residual, which is what f32
arithmetic can certify; ``check_every`` sets how often the residual is
measured (the reference measures every 5 iterations, src/core/solver.ts:166).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional

import numpy as np


class ConvergenceMode(str, enum.Enum):
    """The reference's 5-mode enum (src/types.rs:10-34)."""

    L2_RESIDUAL = "l2"
    L1_RESIDUAL = "l1"
    MAX_RESIDUAL = "max"
    RELATIVE_CHANGE = "relative_change"
    COMBINED = "combined"


class Method(str, enum.Enum):
    NEUMANN = "neumann"
    RANDOM_WALK = "random-walk"
    FORWARD_PUSH = "forward-push"
    BACKWARD_PUSH = "backward-push"
    BIDIRECTIONAL = "bidirectional"
    CG = "conjugate-gradient"
    BICGSTAB = "bicgstab"
    CHEBYSHEV = "chebyshev"
    JACOBI = "jacobi"
    GAUSS_SEIDEL = "gauss-seidel"
    SOR = "sor"
    HYBRID = "hybrid"
    BMSSP = "bmssp"
    ADAPTIVE = "adaptive"


# aliases accepted at API boundaries (CLI/MCP/JSON)
METHOD_ALIASES = {
    "cg": Method.CG,
    "conjugate_gradient": Method.CG,
    "random_walk": Method.RANDOM_WALK,
    "forward_push": Method.FORWARD_PUSH,
    "backward_push": Method.BACKWARD_PUSH,
    "gauss_seidel": Method.GAUSS_SEIDEL,
    "auto": Method.ADAPTIVE,
}


def parse_method(name) -> Method:
    if isinstance(name, Method):
        return name
    name = str(name).strip().lower()
    if name in METHOD_ALIASES:
        return METHOD_ALIASES[name]
    return Method(name)


@dataclasses.dataclass
class SolverOptions:
    """Unified options across all solvers.

    Defaults match the reference: epsilon=1e-6, max_iterations=1000
    (src/core/types.ts:28-35, src/solver/mod.rs:46-56).
    """

    method: Method = Method.ADAPTIVE
    epsilon: float = 1e-6
    max_iterations: int = 1000
    convergence: str = "relative"  # 'relative' | 'absolute'
    convergence_mode: ConvergenceMode = ConvergenceMode.L2_RESIDUAL
    check_every: int = 5
    timeout: Optional[float] = None  # seconds; enforced host-side
    seed: int = 0
    dtype: Any = None  # torch.dtype; None -> float32
    # push-specific (reference: forward_push.rs:26-49, alpha=0.15)
    push_alpha: float = 0.15
    # random-walk specific (reference: random_walk.rs:9-29)
    num_walks: Optional[int] = None
    max_walk_length: int = 1000
    variance_reduction: str = "antithetic"  # none|antithetic|control-variates
    # sampling strategy (reference: sampling.rs:9-120 AdaptiveSampler)
    sampling: str = "importance"  # importance|uniform|stratified|qmc|adaptive
    # initial guess / warm restart (reference: solver/mod.rs:36, neumann.rs:436)
    x0: Optional[Any] = None
    collect_stats: bool = False

    def __post_init__(self):
        if self.epsilon <= 0:
            from .errors import InvalidParametersError

            raise InvalidParametersError(f"epsilon must be positive, got {self.epsilon}")
        if self.max_iterations <= 0:
            from .errors import InvalidParametersError

            raise InvalidParametersError(
                f"max_iterations must be positive, got {self.max_iterations}"
            )
        if not isinstance(self.method, Method):
            self.method = parse_method(self.method)

    # Presets mirroring the reference's src/solver/mod.rs:58-116
    @classmethod
    def high_precision(cls) -> "SolverOptions":
        return cls(epsilon=1e-10, max_iterations=10000, check_every=1)

    @classmethod
    def fast(cls) -> "SolverOptions":
        return cls(epsilon=1e-4, max_iterations=200, check_every=10)

    @classmethod
    def streaming(cls) -> "SolverOptions":
        return cls(check_every=1)


@dataclasses.dataclass
class SolverStats:
    """The reference's src/types.rs:88-109."""

    total_time_ms: float = 0.0
    matvec_count: int = 0
    flops: int = 0
    nnz_per_second: float = 0.0
    backend: str = ""
    device_count: int = 1


@dataclasses.dataclass
class ErrorBounds:
    """Solution error bounds (reference: src/types.rs:60-69, :253-300).

    ``method``: deterministic | probabilistic | adaptive | neumann_truncation.
    Deterministic bounds use the Varah bound for strictly diagonally dominant
    A: ||A^-1||_inf <= 1/alpha with alpha = min_i(|a_ii| - sum_j |a_ij|), so
    ||x - x*||_inf <= ||r||/alpha.  Neumann truncation bounds follow the
    reference's src/solver/neumann.rs:321-347 (geometric series tail).
    """

    lower_bound: float
    upper_bound: float
    confidence: Optional[float] = None
    method: str = "deterministic"

    def is_valid(self) -> bool:
        return (
            self.lower_bound <= self.upper_bound
            and self.lower_bound >= 0.0
            and self.upper_bound >= 0.0
        )

    def width(self) -> float:
        return self.upper_bound - self.lower_bound

    def midpoint(self) -> float:
        return (self.lower_bound + self.upper_bound) / 2.0

    def to_dict(self) -> dict:
        d = {
            "lowerBound": float(self.lower_bound),
            "upperBound": float(self.upper_bound),
            "method": self.method,
        }
        if self.confidence is not None:
            d["confidence"] = float(self.confidence)
        return d


@dataclasses.dataclass
class SolverResult:
    """The reference's TS SolverResult (src/core/types.ts:37-46)."""

    solution: np.ndarray
    iterations: int
    residual: float
    converged: bool
    method: str
    compute_time_ms: float = 0.0
    memory_used: int = 0
    stats: Optional[SolverStats] = None
    phases: Optional[list] = None
    error_bounds: Optional[ErrorBounds] = None
    distribution: Optional[dict] = None

    def to_dict(self) -> dict:
        d = {
            "solution": np.asarray(self.solution).tolist(),
            "iterations": int(self.iterations),
            "residual": float(self.residual),
            "converged": bool(self.converged),
            "method": self.method,
            "computeTime": float(self.compute_time_ms),
            "memoryUsed": int(self.memory_used),
        }
        if self.stats is not None:
            d["stats"] = dataclasses.asdict(self.stats)
        if self.error_bounds is not None:
            d["errorBounds"] = self.error_bounds.to_dict()
        if self.distribution is not None:
            d["distribution"] = dict(self.distribution)
        return d
