"""Chebyshev semi-iterative acceleration of the Jacobi/Neumann iteration, as
in ``sublinear_tpu/solvers/chebyshev.py``.

The iteration runs on D^-1 A x = D^-1 b, whose spectrum lies in
[1 - rho, 1 + rho] for a diagonally dominant A (Gershgorin), and converges
like (rho / (1 + sqrt(1 - rho^2)))^k where the Neumann series converges like
rho^k.  A step is one ``op.matvec`` and a few AXPYs in plain torch over
whatever operator ``Matrix.op()`` gives (on the ``"csr"`` route the product
is the ``csr_spmv`` kernel).  The step coefficients depend on rho and the
step number only, so the host computes them in float32, as the JAX loop
does on the device, and a block of ``check_every`` steps enqueues without a
host sync; ``base.while_iterate`` reads the residual once per block.
"""
from __future__ import annotations

import numpy as np
import torch

from ..analysis import analyze
from ..matrix import Matrix
from ..types import SolverOptions, SolverResult
from . import base


def _coefficients(k: int, rho_prev, delta):
    """(rho_k, alpha_k, beta_k) of Saad's alg. 12.1 with theta = 1, in
    float32: rho_0 = delta, alpha_0 = 1, beta_0 = 0; then
    rho_k = 1 / (2 sigma1 - rho_{k-1}), alpha_k = 2 rho_k / delta,
    beta_k = rho_k rho_{k-1}, sigma1 = 1 / delta."""
    one, two = np.float32(1.0), np.float32(2.0)
    if k == 0:
        return delta, one, np.float32(0.0)
    rho_cur = one / (two * (one / delta) - rho_prev)
    return rho_cur, two * rho_cur / delta, rho_cur * rho_prev


def _chebyshev_run(op, b, x0, rho, threshold, max_iters, check_every,
                   norm_mode="l2", mode="residual", change_tol=0.0):
    inv_d = op.inv_diag
    delta = np.float32(rho)

    def step(state):
        # d_k = alpha_k r_k + beta_k d_{k-1};  x_{k+1} = x_k + d_k
        x, d, rho_prev, k = state
        r = inv_d * (b - op.matvec(x))
        rho_cur, alpha, beta = _coefficients(k, rho_prev, delta)
        d_new = float(alpha) * r + float(beta) * d
        return x + d_new, d_new, rho_cur, k + 1

    def residual_of(state):
        return base.device_norm(op.matvec(state[0]) - b, norm_mode)

    state0 = (x0, torch.zeros_like(x0), np.float32(0.0), 0)
    state, k, res, change = base.while_iterate(
        base.repeat_steps(step, check_every), residual_of, state0, threshold,
        max_iters, check_every, x_of=lambda st: st[0], mode=mode,
        change_tol=change_tol,
    )
    return state[0], k, res, change


def solve_chebyshev(matrix: Matrix, b, options: SolverOptions,
                    raise_on_fail: bool = True) -> SolverResult:
    a = analyze(matrix, estimate_condition=False)
    rho = min(max(float(a.spectral_radius_estimate or 0.9), 1e-3), 0.999)
    op, b_dev, x0, threshold = base.prepare(matrix, b, options)
    with base.SolveTimer(matrix.device) as t:
        x, k, res, change = _chebyshev_run(
            op, b_dev, x0, rho, threshold, options.max_iterations,
            options.check_every, base.norm_mode_of(options),
            base.driver_mode_of(options), options.epsilon,
        )
    result = base.finalize(matrix, x, k, res, "chebyshev", options, t.ms,
                           matvec_count=k)
    return base.check_outcome(result, threshold, options, raise_on_fail,
                              change=change)
