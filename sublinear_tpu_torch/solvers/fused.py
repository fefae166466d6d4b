"""Convergence-checked solver over the dense fused kernels, as in
``sublinear_tpu/solvers/fused.py``.

The kernels (``ops/dense_fused.py``) run a fixed block of iterations; this
module measures the true l2 residual ||A x - b|| between blocks.  The JAX
package runs that loop on the device in a ``lax.while_loop``; here it is a
host loop with one scalar read per block and the same stop rule
(``base.running``): a first block, then blocks while the residual is above
the threshold, finite and below ``HUGE_RES`` and fewer than
``max_iterations`` iterations have run.

Variant selection, on the JAX package's 128-rounded sides: the full-f32
product up to ``FUSED_HIGHEST_MAX_NPAD``, the bf16x3 split product up to
``FUSED_MAX_NPAD``.  ``solve_neumann`` takes the matrix when the fused path
does not apply, or when the bf16x3 variant would have to reach a relative
residual below 1e-4, its floor.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..config import host_float
from ..matrix import Matrix
from ..ops import dense_fused as df
from ..ops import spmv
from ..types import SolverOptions, SolverResult
from . import base


def _variant(op) -> str:
    return ("highest" if df.lanes(op.shape[0]) <= df.FUSED_HIGHEST_MAX_NPAD
            else "bf16x3")


def _square(op, *vectors):
    """``(A, diag, inv_diag, *vectors)`` on a square domain.  The JAX
    package's operators pad both sides to multiples of 128, so a
    fused-supported operator is square there; the port's are unpadded, so a
    non-square one (say 100 x 120) gets zero rows or columns, and vectors
    zero entries, which leaves the iteration on the first entries as the
    JAX package computes it."""
    n, m = op.shape
    if n == m:
        return (op.data, op.diag, op.inv_diag, *vectors)
    s = max(n, m)
    a = op.data.new_zeros((s, s))
    a[:n, :m] = op.data

    def pad(v):  # zero rows below v's
        out = v.new_zeros((s,) + tuple(v.shape[1:]))
        out[: v.shape[0]] = v
        return out

    return (a, pad(op.diag), pad(op.inv_diag), *map(pad, vectors))


def solve_neumann_fused(matrix: Matrix, b, options: SolverOptions,
                        raise_on_fail: bool = True,
                        block: int = 8) -> SolverResult:
    op = matrix.op(options.dtype)
    if not df.fused_supported(op):
        from .neumann import solve_neumann

        return solve_neumann(matrix, b, options, raise_on_fail)

    variant = _variant(op)
    if variant == "bf16x3":
        # bf16x3 products floor at ~1e-4 relative residual; tighter
        # tolerances take the full-f32 Neumann path
        nb = float(np.linalg.norm(np.asarray(b, dtype=np.float64)))
        rel_target = (options.epsilon if options.convergence == "relative"
                      else options.epsilon / max(nb, 1e-30))
        if rel_target < 1e-4:
            from .neumann import solve_neumann

            return solve_neumann(matrix, b, options, raise_on_fail)

    _, b_dev, x0, threshold = base.prepare(matrix, b, options)
    a, diag, dinv, b_col, x = _square(op, b_dev[:, None], x0[:, None])
    diag, dinv = diag[:, None], dinv[:, None]
    if variant == "bf16x3":
        ah, al = df.split_bf16(a)

    def kernel_block(x):
        if variant == "bf16x3":
            return df.dense_neumann_fused_bf16x3(ah, al, diag, dinv, b_col, x,
                                                 iters=block)
        return df.dense_neumann_fused(a, diag, dinv, b_col, x, iters=block)

    def residual_of(x):
        return torch.linalg.vector_norm(spmv.dense_matvec(a, x[:, 0])
                                        - b_col[:, 0])

    with base.SolveTimer(matrix.device) as t:
        x = kernel_block(x)
        k = block
        # the loop's one read per block
        res, lims = base.first_check(residual_of(x), threshold)
        while base.running(res, math.inf, k, options.max_iterations, lims):
            x = kernel_block(x)
            k += block
            res = host_float(residual_of(x))
    # the rows of b: _square may have added zero rows below them
    result = base.finalize(matrix, x[: matrix.shape[0], 0], k, res,
                           f"neumann-fused-{variant}", options, t.ms,
                           matvec_count=k)
    return base.check_outcome(result, threshold, options, raise_on_fail)
