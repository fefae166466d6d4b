"""Forward, backward and bidirectional push, in the masked-frontier form of
``sublinear_tpu/solvers/push.py``.

Each sweep pushes every node whose residual passes the threshold at once:

    frontier  m = |r| >= eta * max|r|
    delta     = where(m, r / diag, 0)
    x        += delta ;  r -= A @ delta

This is Jacobi restricted to the frontier, with the same fixed point, so it
converges for strictly diagonally dominant systems; iterations count sweeps.
A sweep is a handful of torch operations and one ``op.matvec`` (on the
``"csr"`` route the ``csr_spmv`` kernel); ``base.while_iterate`` reads the
residual norm once per block of ``check_every`` sweeps.  Backward push runs
the same sweeps on A^T (``adjoint_solve``); for a full solve it runs them on
A, as the JAX package does.  Bidirectional finishes a capped push phase with
a BiCGSTAB polish from its iterate.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import to_host
from ..matrix import Matrix
from ..types import SolverOptions, SolverResult
from . import base

# fraction of the max residual a node needs to enter the frontier; 0 would be
# plain Jacobi, 1 would be single-node Gauss-Southwell.
FRONTIER_ETA = 0.1


def _push_run(op, b, x0, threshold, max_iters, check_every, norm_mode="l2",
              mode="residual", change_tol=0.0):
    inv_d = op.inv_diag

    def sweep(state):
        x, r = state
        mag = r.abs()
        frontier = mag >= FRONTIER_ETA * mag.max()
        delta = torch.where(frontier, r * inv_d, torch.zeros_like(r))
        return x + delta, r - op.matvec(delta)

    def residual_of(state):
        return base.device_norm(state[1], norm_mode)

    r0 = b - op.matvec(x0)
    state, k, res, change = base.while_iterate(
        base.repeat_steps(sweep, check_every), residual_of, (x0, r0),
        threshold, max_iters, check_every, x_of=lambda st: st[0], mode=mode,
        change_tol=change_tol,
    )
    return state[0], k, res, change


def solve_push(matrix: Matrix, b, options: SolverOptions,
               direction: str = "forward-push",
               raise_on_fail: bool = True) -> SolverResult:
    op, b_dev, x0, threshold = base.prepare(matrix, b, options)

    if direction == "bidirectional":
        # push phase with a loose budget, then BiCGSTAB from its iterate
        with base.SolveTimer(matrix.device) as t:
            x, k, _, _ = _push_run(
                op, b_dev, x0, threshold,
                max(options.max_iterations // 4, 8), options.check_every,
                base.norm_mode_of(options))
        from . import cg as _cg

        polish_opts = dataclasses.replace(options,
                                          x0=to_host(x, np.float64))
        polish = _cg.solve_bicgstab(matrix, b, polish_opts,
                                    raise_on_fail=raise_on_fail)
        polish.method = "bidirectional"
        polish.iterations += k
        polish.compute_time_ms += t.ms
        return polish

    with base.SolveTimer(matrix.device) as t:
        x, k, res, change = _push_run(
            op, b_dev, x0, threshold, options.max_iterations,
            options.check_every, base.norm_mode_of(options),
            base.driver_mode_of(options), options.epsilon)
    result = base.finalize(matrix, x, k, res, direction, options, t.ms,
                           matvec_count=k)
    return base.check_outcome(result, threshold, options, raise_on_fail,
                              change=change)


def adjoint_solve(matrix: Matrix, e, options: SolverOptions):
    """Solve A^T y = e with backward (adjoint) push sweeps, as the JAX
    package's single-entry queries use it.  Returns ``(y, sweeps,
    residual)`` with y a tensor on the matrix's device, of the transpose
    operator's length."""
    opT = matrix.op(options.dtype, transpose=True)
    e_dev = matrix.pad_vector(e, options.dtype, transpose=True)
    threshold = base.threshold_for(e, options)
    y, k, res, _ = _push_run(opT, e_dev, torch.zeros_like(e_dev), threshold,
                             options.max_iterations, options.check_every)
    return y, k, res
