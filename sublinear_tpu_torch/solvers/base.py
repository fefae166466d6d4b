"""Shared solver driver machinery, as in ``sublinear_tpu/solvers/base.py``.

The JAX package runs the whole iteration inside one ``lax.while_loop``.
Here ``while_iterate`` is a host loop with the same stop rule and the same
carry ``(state, k, res, change)``: each pass enqueues ``check_every`` steps
and the residual on the device, then reads the residual back, which is the
loop's one device-to-host sync per chunk.
"""
from __future__ import annotations

import math
import time
from typing import Callable

import numpy as np
import torch

from ..errors import ConvergenceError, NumericalInstabilityError
from ..matrix import Matrix
from ..types import ConvergenceMode, ErrorBounds, SolverOptions, SolverResult, SolverStats

HUGE_RES = 1e30


def norm_mode_of(options: SolverOptions) -> str:
    """Map ConvergenceMode (reference: src/types.rs:10-34) to a norm tag."""
    mode = options.convergence_mode
    if mode in (ConvergenceMode.L1_RESIDUAL,):
        return "l1"
    if mode in (ConvergenceMode.MAX_RESIDUAL,):
        return "max"
    return "l2"  # RELATIVE_CHANGE/COMBINED report the l2 residual; their
    # convergence tests run on iterate change inside while_iterate


def device_norm(v: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "l1":
        return torch.sum(torch.abs(v))
    if mode == "max":
        return torch.max(torch.abs(v))
    return torch.linalg.vector_norm(v)


def host_norm(v, mode: str) -> float:
    v = np.asarray(v, dtype=np.float64)
    if mode == "l1":
        return float(np.abs(v).sum())
    if mode == "max":
        return float(np.abs(v).max()) if v.size else 0.0
    return float(np.linalg.norm(v))


def threshold_for(b: np.ndarray, options: SolverOptions) -> float:
    """Absolute threshold (in the configured norm) implementing
    relative/absolute convergence."""
    if options.convergence == "absolute":
        return float(options.epsilon)
    nb = host_norm(b, norm_mode_of(options))
    return float(options.epsilon) * max(nb, 1e-30)


def _as_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``: the JAX loop compares its f32
    residual with the threshold in f32, so the host loop does too."""
    return float(torch.tensor(value, dtype=dtype))


def limits(dtype: torch.dtype, threshold: float, change_tol: float = 0.0):
    """(threshold, divergence bound, change tolerance) rounded to the
    residual's dtype, for ``running``."""
    return tuple(_as_dtype(v, dtype) for v in (threshold, HUGE_RES, change_tol))


def running(res: float, change: float, k: int, max_iters: int, lims,
            mode: str = "residual") -> bool:
    """The JAX while_loop's condition: not yet converged under ``mode``,
    within the iteration budget, and not diverged (non-finite or exploding
    residual).  ``lims`` comes from ``limits``."""
    thr, huge, tol = lims
    if mode == "relative_change":
        not_done = change > tol
    elif mode == "combined":
        not_done = res > thr or change > tol
    else:
        not_done = res > thr
    return not_done and k < max_iters and math.isfinite(res) and res < huge


def while_iterate(step_block: Callable, residual_of: Callable, state0, threshold, max_iters: int, check_every: int, x_of: Callable | None = None, mode: str = "residual", change_tol: float = 0.0):
    """Generic host-driven loop.

    ``step_block(state)``   advances the iterate by ``check_every`` steps
    ``residual_of(state)``  returns the residual norm of the current iterate
                            (a 0-d tensor)
    ``x_of(state)``         extracts the iterate (required for the
                            RELATIVE_CHANGE / COMBINED convergence modes)

    Carry is (state, k, res, change).  ``mode``:
      'residual'        stop on res <= threshold
      'relative_change' stop on ||x_new - x_old|| / ||x_old|| <= change_tol
      'combined'        require BOTH conditions
    Stops on convergence, divergence (non-finite or exploding residual), or
    iteration budget.  Returns (state, k, res, change) with host numbers.
    """
    res_t = residual_of(state0)
    lims = limits(res_t.dtype, threshold, change_tol)
    res, change = float(res_t), math.inf
    state, k = state0, 0
    while running(res, change, k, max_iters, lims, mode):
        new_state = step_block(state)
        if x_of is not None and mode in ("relative_change", "combined"):
            x_old, x_new = x_of(state), x_of(new_state)
            change = float(torch.linalg.vector_norm(x_new - x_old)
                           / torch.clamp(torch.linalg.vector_norm(x_old), min=1e-30))
        state = new_state
        k += check_every
        res = float(residual_of(state))
    return state, k, res, change


def driver_mode_of(options: SolverOptions) -> str:
    mode = options.convergence_mode
    if mode is ConvergenceMode.RELATIVE_CHANGE:
        return "relative_change"
    if mode is ConvergenceMode.COMBINED:
        return "combined"
    return "residual"


def dd_error_bounds(matrix: Matrix, residual_norm: float):
    """Deterministic solution-error bound for strictly DD matrices via the
    Varah bound ||A^-1||_inf <= 1/alpha, alpha = min_i(|a_ii| - sum|a_ij|):
    ||x - x*||_inf <= ||r|| / alpha.  None when A is not strictly DD or the
    residual is non-finite."""
    alpha = matrix.dominance_gap()
    if alpha <= 0.0 or not np.isfinite(residual_norm):
        return None
    return ErrorBounds(
        lower_bound=0.0,
        upper_bound=float(residual_norm) / alpha,
        method="deterministic",
    )


def neumann_truncation_bounds(matrix: Matrix, terms: int, term_norm: float, rhs_norm: float, residual: float):
    """Geometric-series truncation bound (reference:
    src/solver/neumann.rs:321-347): estimate q = ||M|| from the last term's
    decay, bound the tail q^k/(1-q) * ||D^-1 b||.  Falls back to the
    deterministic Varah bound when q >= 1 or too few terms."""
    if terms > 1 and rhs_norm > 0 and term_norm > 0 and np.isfinite(term_norm):
        q = (term_norm / rhs_norm) ** (1.0 / (terms - 1))
        if 0.0 < q < 1.0:
            tail = (q ** terms) / (1.0 - q) * rhs_norm
            det = dd_error_bounds(matrix, residual)
            if det is not None and det.upper_bound < tail:
                return det
            return ErrorBounds(lower_bound=0.0, upper_bound=float(tail),
                               method="neumann_truncation")
    return dd_error_bounds(matrix, residual)


class SolveTimer:
    """Wall time of a block of work on ``device``: on a CUDA device it
    synchronises that device before reading the clock on entry and on
    exit."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.ms = (time.perf_counter() - self.t0) * 1e3
        return False


def finalize(
    matrix: Matrix,
    x_pad: torch.Tensor,
    iterations,
    residual,
    method: str,
    options: SolverOptions,
    elapsed_ms: float,
    matvec_count: int = 0,
    error_bounds=None,
) -> SolverResult:
    n = matrix.shape[0]
    x = x_pad.detach().cpu().numpy().astype(np.float64)[:n]
    res = float(residual)
    result = SolverResult(
        solution=x,
        iterations=int(iterations),
        residual=res,
        converged=bool(np.isfinite(res)),
        method=method,
        compute_time_ms=elapsed_ms,
        error_bounds=error_bounds if error_bounds is not None else dd_error_bounds(matrix, res),
    )
    if options.collect_stats:
        nnz = matrix.nnz
        secs = max(elapsed_ms / 1e3, 1e-12)
        result.stats = SolverStats(
            total_time_ms=elapsed_ms,
            matvec_count=matvec_count,
            flops=2 * nnz * matvec_count,
            nnz_per_second=nnz * matvec_count / secs,
            backend=x_pad.device.type,
            device_count=torch.cuda.device_count(),
        )
    return result


def check_outcome(result: SolverResult, threshold: float, options: SolverOptions, raise_on_fail: bool, change: float | None = None):
    mode = options.convergence_mode
    res_ok = bool(np.isfinite(result.residual) and result.residual <= threshold * 1.0000001)
    if change is not None and mode in (ConvergenceMode.RELATIVE_CHANGE, ConvergenceMode.COMBINED):
        chg_ok = bool(np.isfinite(change) and change <= options.epsilon * 1.0000001)
        result.converged = (
            chg_ok if mode is ConvergenceMode.RELATIVE_CHANGE else (chg_ok and res_ok)
        )
    else:
        result.converged = res_ok
    if not result.converged and raise_on_fail:
        if not np.isfinite(result.residual) or result.residual >= HUGE_RES:
            raise NumericalInstabilityError(
                f"{result.method} diverged (residual={result.residual})",
                {"iterations": result.iterations},
            )
        raise ConvergenceError(
            f"{result.method} failed to converge after {result.iterations} iterations; "
            f"residual {result.residual:.3e} > threshold {threshold:.3e}",
            {"residual": result.residual, "iterations": result.iterations, "threshold": threshold},
        )
    return result
