"""Batched solves, as in ``sublinear_tpu/parallel/sharded.py`` (its
single-device part: ``solve_batch``).

``solve_batch`` solves A X = B for a block of right-hand sides at once, each
column held to its own threshold.  The JAX package runs a batch inside one
``lax.while_loop``; here ``_neumann_batch_run`` and ``_cg_batch_run`` are host
loops with the same recurrences and stop rule that read the column
residuals back once per iteration, so the iteration counts match.  Each
iteration's product is ``op.matmat`` on ``Matrix.op(batch=True)``: on the
``"csr"`` route, the ``csr_spmm`` kernel (``ops/csr_spmv.py``).  Both run
n-major ((n, B) state) on every operator; the JAX package's batch-major
branch is a layout for its TPU gathers.  A Neumann batch of at most
``CHAIN_MAX_RHS`` columns on a chain-ready operator runs as serialized chain
solves (``solvers/neumann.py::_neumann_run`` per column, the
``neumann_step`` kernel), as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import to_device
from ..errors import DimensionMismatchError
from ..matrix import Matrix
from ..solvers import base
from ..solvers.neumann import _neumann_run
from ..types import SolverOptions, SolverResult

_TINY = 1e-30
CHAIN_MAX_RHS = 32


def _col_norms(R: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(R, dim=0)


def _running(res: np.ndarray, thresholds: np.ndarray, k: int,
             max_iters: int) -> bool:
    """The JAX loop's condition on host copies of the column residuals and
    the thresholds (both in the operator's dtype)."""
    return bool(np.any(res > thresholds) and k < max_iters
                and np.all(np.isfinite(res)))


def _cg_batch_run(op, B, thresholds, max_iters):
    """Jacobi-preconditioned CG over the columns of B (n, nrhs) from X = 0,
    with per-column ``thresholds``.  Returns (X, k, host column
    residuals)."""
    inv_d = op.inv_diag[:, None]
    X = torch.zeros_like(B)
    R = B - op.matmat(X)
    Z = inv_d * R
    P = Z
    rz = torch.sum(R * Z, dim=0)
    k = 0
    # the loop's one device-to-host sync per iteration
    while _running(_col_norms(R).cpu().numpy(), thresholds, k, max_iters):
        AP = op.matmat(P)
        alpha = rz / torch.clamp(torch.sum(P * AP, dim=0), min=_TINY)
        X = X + alpha * P
        R = R - alpha * AP
        Z = inv_d * R
        rz_new = torch.sum(R * Z, dim=0)
        P = Z + rz_new / torch.clamp(rz, min=_TINY) * P
        rz = rz_new
        k += 1
    return X, k, _col_norms(R).cpu().numpy()


def _neumann_batch_run(op, B, thresholds, max_iters):
    """The batched Neumann series from X = 0 (the JAX package's
    ``x0_zero=True``), with per-column ``thresholds``.  The residual identity
    r(X_k) = -R_off T_k gives each iteration's column residuals from its own
    product; the first check is forced by a large finite seed and k starts
    at 1.  The returned residuals are the exact B - A X column norms,
    measured once after the loop.  Returns (X, k, host column residuals)."""
    inv_d, diag = op.inv_diag[:, None], op.diag[:, None]
    T = inv_d * B
    X = T
    k = 1
    res = np.full(B.shape[1], torch.finfo(B.dtype).max / 4)
    while _running(res, thresholds, k, max_iters):
        RT = op.matmat(T) - diag * T
        res = _col_norms(RT).cpu().numpy()
        T = -inv_d * RT
        X = X + T
        k += 1
    return X, k, _col_norms(B - op.matmat(X)).cpu().numpy()


def _chain_columns(op, Bt, thr_cols, options: SolverOptions):
    """One chain solve per row of Bt (nrhs, n): returns (X (n, nrhs), the
    largest iteration count, host column residuals)."""
    xs, ks, ress = [], [], []
    for b, thr in zip(Bt, thr_cols):
        x, k, res, *_ = _neumann_run(op, b, torch.zeros_like(b), float(thr),
                                     options.max_iterations,
                                     options.check_every)
        xs.append(x)
        ks.append(k)
        ress.append(res)
    return torch.stack(xs, dim=1), max(ks), np.asarray(ress)


def solve_batch(
    matrix: Matrix,
    B,
    options: Optional[SolverOptions] = None,
    mesh=None,
    raise_on_fail: bool = False,
    method: str = "auto",
):
    """Solve A X = B for many RHS at once (B: (n, nrhs)); returns one
    SolverResult per column, with method ``f"{method}-batch"``.

    ``method``: 'cg' | 'neumann' | 'auto' (CG when symmetric, else the
    DD-convergent batched Neumann series); any other string runs CG, as in
    the JAX package.  Columns that do not converge are reported with
    ``converged=False`` (``raise_on_fail`` is accepted for the JAX
    signature and, as there, not acted on).  ``mesh`` is not ported yet."""
    options = options or SolverOptions()
    n = matrix.shape[0]
    B = np.asarray(B, dtype=np.float64)
    if B.ndim != 2 or B.shape[0] != n:
        raise DimensionMismatchError(f"batch RHS must be (n, k), got {B.shape}")
    if mesh is not None:
        raise NotImplementedError(
            "solve_batch over a device mesh is not ported yet (ROADMAP queue "
            "1, item 11)")

    nrhs = B.shape[1]
    op = matrix.op(options.dtype, batch=True)
    norms = np.linalg.norm(B, axis=0)
    # Per-column thresholds: eps * ||b_j|| for 'relative', so a column whose
    # RHS norm is orders of magnitude below its neighbours still meets its
    # OWN relative tolerance (not eps * max_j ||b_j||).
    if options.convergence == "relative":
        thr_cols = float(options.epsilon) * np.maximum(norms, 1e-30)
    else:
        thr_cols = np.full(nrhs, float(options.epsilon))

    if method == "auto":
        from ..analysis import analyze

        a = analyze(matrix, estimate_condition=False)
        method = "cg" if a.is_symmetric else (
            "neumann" if a.is_diagonally_dominant else "cg"
        )
    # small-batch path: serialized chain solves, each column with its own
    # convergence check (the JAX package's conditions)
    chain_op = None
    if method == "neumann" and nrhs <= CHAIN_MAX_RHS and options.x0 is None:
        op1 = matrix.op(options.dtype)
        if getattr(op1, "chain_ready", False) and options.check_every > 1:
            chain_op = op1

    # the port's operators pad no domain (n_pad == n), so B goes up as it is
    with base.SolveTimer(matrix.device) as t:
        if chain_op is not None:
            Bt = to_device(B.T, chain_op.dtype, matrix.device)
            X, k, col_res = _chain_columns(chain_op, Bt, thr_cols, options)
        else:
            B_dev = to_device(B, op.dtype, matrix.device)
            np_dtype = torch.empty(0, dtype=op.dtype).numpy().dtype
            run = _neumann_batch_run if method == "neumann" else _cg_batch_run
            X, k, col_res = run(op, B_dev, thr_cols.astype(np_dtype),
                                options.max_iterations)

    X_host = X.detach().cpu().numpy().astype(np.float64)
    res = np.asarray(col_res, dtype=np.float64)
    return [
        SolverResult(
            solution=X_host[:, j],
            iterations=int(k),
            residual=float(res[j]),
            converged=bool(res[j] <= thr_cols[j] * 1.0000001),
            method=f"{method}-batch",
            compute_time_ms=t.ms,
        )
        for j in range(nrhs)
    ]
