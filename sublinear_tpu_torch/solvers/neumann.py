"""Truncated Neumann-series solver, as in ``sublinear_tpu/solvers/neumann.py``.

With A = D + R_off, the iteration matrix is M = I - D^-1 A and

    x = sum_k M^k D^-1 b,   term_{k+1} = -D^-1 R_off term_k

(the reference's Rust form, src/solver/neumann.rs:252-299).  Warm restart is
the series on the residual b - A x0, added to x0.  The iteration runs on the
operator's device; the host loop in ``base.while_iterate`` checks the
residual once per ``check_every`` chunk.
"""
from __future__ import annotations

import numpy as np
import torch

from ..matrix import Matrix
from ..types import SolverOptions, SolverResult
from . import base


def _neumann_run(op, b, x0, threshold, max_iters, check_every, norm_mode="l2", mode="residual", change_tol=0.0):
    inv_d = op.inv_diag
    r0 = b - op.matvec(x0)
    term0 = inv_d * r0

    def residual_of(state):
        x, _ = state
        return base.device_norm(op.matvec(x) - b, norm_mode)

    if getattr(op, "chain_ready", False) and check_every > 1:
        # one chunk = check_every Neumann iterations as one chain of
        # neumann_step kernels (ops/csr_spmv.py)
        def step_block(state):
            x, term = state
            acc, term2 = op.neumann_chain(term, check_every)
            return x + (acc - term), term2
    else:
        def step_block(state):
            x, term = state
            for _ in range(check_every):
                term = -inv_d * op.offdiag_matvec(term)
                x = x + term
            return x, term

    state0 = (x0 + term0, term0)
    (state, k, res, change) = base.while_iterate(
        step_block, residual_of, state0, threshold,
        max_iters, check_every, x_of=lambda st: st[0], mode=mode,
        change_tol=change_tol,
    )
    x, term = state
    # geometric-tail data for the truncation error bound
    # (reference: src/solver/neumann.rs:321-347)
    return (x, k, res, change, float(torch.linalg.vector_norm(term)),
            float(torch.linalg.vector_norm(term0)))


def solve_neumann(matrix: Matrix, b, options: SolverOptions, raise_on_fail: bool = True) -> SolverResult:
    op = matrix.op(options.dtype)
    b_pad = matrix.pad_vector(b, options.dtype)
    if options.x0 is not None:
        x0 = matrix.pad_vector(options.x0, options.dtype)
    else:
        x0 = torch.zeros_like(b_pad)
    threshold = base.threshold_for(b, options)

    with base.SolveTimer(matrix.device) as t:
        x, k, res, change, term_n, rhs_n = _neumann_run(
            op, b_pad, x0, threshold, options.max_iterations, options.check_every,
            base.norm_mode_of(options), base.driver_mode_of(options), options.epsilon,
        )
    eb = base.neumann_truncation_bounds(matrix, k, term_n, rhs_n, res)
    result = base.finalize(
        matrix, x, k, res, "neumann", options, t.ms,
        matvec_count=int(np.ceil(k * (1 + 1 / max(options.check_every, 1)))),
        error_bounds=eb,
    )
    return base.check_outcome(result, threshold, options, raise_on_fail,
                              change=change)
