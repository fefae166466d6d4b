"""Conjugate gradient and BiCGSTAB, as in ``sublinear_tpu/solvers/cg.py``.

The JAX package runs each solve inside one ``lax.while_loop``.  Here they are
host loops with the same recurrences and stop rules:

- ``_cg_chain_run`` (a chain-ready ``"csr"`` operator, Jacobi preconditioning,
  the residual stop rule, ``check_every > 1``) runs chunks of CG steps as one
  ``CsrOperator.cg_chain`` each (the ``cg_step`` kernel on the card) and
  reads back one scalar, ``||r||^2``, per chunk;
- ``_cg_run`` and ``_bicgstab_run`` run one step per pass and read the
  residual (and the iterate change) back after every step: one host sync
  per iteration.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..matrix import Matrix
from ..ops.csr_spmv import dot64
from ..types import SolverOptions, SolverResult
from . import base

_TINY = 1e-30


def _cg_run(op, b, x0, threshold, max_iters, precondition, mode="residual",
            change_tol=0.0):
    inv_d = op.inv_diag

    def M(v):  # Jacobi preconditioner
        return inv_d * v if precondition else v

    r = b - op.matvec(x0)
    z = M(r)
    p, x = z, x0
    rz = torch.dot(r, z)
    res_t = torch.linalg.vector_norm(r)
    lims = base.limits(res_t.dtype, threshold, change_tol)
    res, change, k = float(res_t), math.inf, 0
    while base.running(res, change, k, max_iters, lims, mode):
        Ap = op.matvec(p)
        alpha = rz / torch.clamp(torch.dot(p, Ap), min=_TINY)
        change_t = (alpha.abs() * torch.linalg.vector_norm(p)
                    / torch.clamp(torch.linalg.vector_norm(x), min=_TINY))
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = torch.dot(r, z)
        p = z + rz_new / torch.clamp(rz, min=_TINY) * p
        rz = rz_new
        k += 1
        # the loop's one device-to-host sync
        res, change = torch.stack(
            (torch.linalg.vector_norm(r), change_t)).tolist()
    return x, k, res, change


def _cg_chain_run(op, b, x0, threshold, max_iters, check_every):
    """Chunked chain PCG: a head chunk of ``2 * check_every`` steps (if not
    yet converged), then tail chunks of ``max(2, check_every // 2)``, each one
    ``op.cg_chain``.  The same recurrence as ``_cg_run`` with Jacobi
    preconditioning; ``rz`` stays on the device between chunks."""
    r = b - op.matvec(x0)
    z = op.inv_diag * r
    state = (x0, r, z, dot64(r, z))
    res_t = torch.linalg.vector_norm(r)
    lims = base.limits(res_t.dtype, threshold)
    res, k = float(res_t), 0
    chunk = 2 * check_every
    while base.running(res, math.inf, k, max_iters, lims):
        x, r, p, rz, res2 = op.cg_chain(*state, chunk)
        state = (x, r, p, rz)
        k += chunk
        # sqrt in f32, as the JAX loop takes it
        res = float(np.sqrt(np.float32(res2.item())))
        chunk = max(2, check_every // 2)
    return state[0], k, res


def _bicgstab_run(op, b, x0, threshold, max_iters, mode="residual",
                  change_tol=0.0):
    def guard(v):  # v where |v| > TINY, else TINY
        return torch.where(v.abs() > _TINY, v, _TINY)

    r = b - op.matvec(x0)
    rhat, x = r, x0
    p = v = torch.zeros_like(b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho = alpha = omega = one
    res_t = torch.linalg.vector_norm(r)
    lims = base.limits(res_t.dtype, threshold, change_tol)
    res, change, k = float(res_t), math.inf, 0
    while base.running(res, change, k, max_iters, lims, mode):
        rho_new = torch.dot(rhat, r)
        beta = (rho_new / guard(rho)) * (alpha / guard(omega))
        p = r + beta * (p - omega * v)
        v = op.matvec(p)
        alpha = rho_new / guard(torch.dot(rhat, v))
        s = r - alpha * v
        t = op.matvec(s)
        tt = torch.dot(t, t)
        omega = torch.dot(t, s) / torch.where(tt > _TINY, tt, _TINY)
        dx = alpha * p + omega * s
        change_t = (torch.linalg.vector_norm(dx)
                    / torch.clamp(torch.linalg.vector_norm(x), min=_TINY))
        x = x + dx
        r = s - omega * t
        rho = rho_new
        k += 1
        # the loop's one device-to-host sync
        res, change = torch.stack(
            (torch.linalg.vector_norm(r), change_t)).tolist()
    return x, k, res, change


def _prepare(matrix: Matrix, b, options: SolverOptions):
    op = matrix.op(options.dtype)
    b_pad = matrix.pad_vector(b, options.dtype)
    x0 = (matrix.pad_vector(options.x0, options.dtype)
          if options.x0 is not None else torch.zeros_like(b_pad))
    return op, b_pad, x0, base.threshold_for(b, options)


def solve_cg(matrix: Matrix, b, options: SolverOptions,
             raise_on_fail: bool = True,
             precondition: bool = True) -> SolverResult:
    op, b_pad, x0, threshold = _prepare(matrix, b, options)
    mode = base.driver_mode_of(options)
    # chain path: chunks of CG steps as cg_chain calls (the JAX package's
    # conditions, cg.py:167-169)
    use_chain = (getattr(op, "chain_ready", False) and precondition
                 and mode == "residual" and options.check_every > 1)
    with base.SolveTimer(matrix.device) as t:
        if use_chain:
            x, k, res = _cg_chain_run(op, b_pad, x0, threshold,
                                      options.max_iterations,
                                      options.check_every)
            change = math.inf
        else:
            x, k, res, change = _cg_run(op, b_pad, x0, threshold,
                                        options.max_iterations, precondition,
                                        mode, options.epsilon)
    result = base.finalize(matrix, x, k, res, "conjugate-gradient", options,
                           t.ms, matvec_count=k + 1)
    return base.check_outcome(result, threshold, options, raise_on_fail,
                              change=change)


def solve_bicgstab(matrix: Matrix, b, options: SolverOptions,
                   raise_on_fail: bool = True) -> SolverResult:
    op, b_pad, x0, threshold = _prepare(matrix, b, options)
    with base.SolveTimer(matrix.device) as t:
        x, k, res, change = _bicgstab_run(
            op, b_pad, x0, threshold, options.max_iterations,
            base.driver_mode_of(options), options.epsilon)
    result = base.finalize(matrix, x, k, res, "bicgstab", options, t.ms,
                           matvec_count=2 * k + 1)
    return base.check_outcome(result, threshold, options, raise_on_fail,
                              change=change)
