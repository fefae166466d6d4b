"""Host utilities of the port, with the exports of
``sublinear_tpu/utils/__init__.py``: checkpoints and warm restart,
convergence tracking, per-solve records and complexity fits.  ``lru``,
``profiling`` (``memory_info``, ``device_trace``) and ``memory_profiler``
are imported by module."""
from .checkpoint import SolverCheckpoint, checkpoint_of, resume, update_rhs
from .complexity import ComplexityFit, classify_exponent, fit_power_law, validate_complexity
from .convergence import ConvergenceChecker, ConvergenceInfo
from .profiling import ProfileLog, SolveRecord, record_solve

__all__ = [
    "SolverCheckpoint",
    "checkpoint_of",
    "resume",
    "update_rhs",
    "ConvergenceChecker",
    "ConvergenceInfo",
    "ProfileLog",
    "SolveRecord",
    "record_solve",
    "ComplexityFit",
    "fit_power_law",
    "classify_exponent",
    "validate_complexity",
]
