"""sublinear_tpu_torch — the PyTorch/CUDA port of ``sublinear_tpu``.

Solvers for diagonally-dominant sparse systems ``A x = b`` on one NVIDIA
H100, with the JAX package's public API.  The JAX package stays the
reference; this package imports neither it nor jax.  The sparse single-RHS
path runs on hand-written CUDA kernels (``csrc/csr_kernels.cu``) that take
the place of the JAX package's Pallas kernels.
"""

__version__ = "0.1.0"

from .analysis import MatrixAnalysis, analyze
from .errors import (
    ConvergenceError,
    DimensionMismatchError,
    InvalidMatrixError,
    InvalidParametersError,
    NotDiagonallyDominantError,
    NumericalInstabilityError,
    SolverError,
)
from .generate import generate, rhs
from .matrix import Matrix
from .solvers.dispatch import select_method, solve
from .types import Method, SolverOptions, SolverResult, SolverStats

__all__ = [
    "Matrix",
    "MatrixAnalysis",
    "Method",
    "SolverOptions",
    "SolverResult",
    "SolverStats",
    "analyze",
    "generate",
    "rhs",
    "select_method",
    "solve",
    "SolverError",
    "ConvergenceError",
    "DimensionMismatchError",
    "InvalidMatrixError",
    "InvalidParametersError",
    "NotDiagonallyDominantError",
    "NumericalInstabilityError",
]
