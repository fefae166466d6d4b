"""Structured error taxonomy for the solver framework.

A copy of ``sublinear_tpu/errors.py``: the same classes and the same
E001..E010 codes, so callers (and the parity tests) can map errors between
the two packages 1:1.
"""
from __future__ import annotations


class SolverError(Exception):
    """Base error. ``code`` follows the reference's E001..E008 convention."""

    code = "E000"

    def __init__(self, message: str, details: dict | None = None):
        super().__init__(message)
        self.message = message
        self.details = details or {}

    def to_dict(self) -> dict:
        return {
            "error": type(self).__name__,
            "code": self.code,
            "message": self.message,
            "details": self.details,
        }


class NotDiagonallyDominantError(SolverError):
    code = "E001"


class ConvergenceError(SolverError):
    code = "E002"


class InvalidMatrixError(SolverError):
    code = "E003"


class TimeoutError_(SolverError):
    code = "E004"


class DimensionMismatchError(SolverError):
    code = "E005"


class NumericalInstabilityError(SolverError):
    code = "E006"


class MemoryLimitError(SolverError):
    code = "E007"


class InvalidParametersError(SolverError):
    code = "E008"


class IndexOutOfBoundsError(SolverError):
    code = "E009"


class AlgorithmError(SolverError):
    code = "E010"


ERROR_CODES = {
    "NOT_DIAGONALLY_DOMINANT": "E001",
    "CONVERGENCE_FAILED": "E002",
    "INVALID_MATRIX": "E003",
    "TIMEOUT": "E004",
    "INVALID_DIMENSIONS": "E005",
    "NUMERICAL_INSTABILITY": "E006",
    "MEMORY_LIMIT_EXCEEDED": "E007",
    "INVALID_PARAMETERS": "E008",
    "INDEX_OUT_OF_BOUNDS": "E009",
    "ALGORITHM_ERROR": "E010",
}
