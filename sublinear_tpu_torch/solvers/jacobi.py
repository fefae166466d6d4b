"""Jacobi, Gauss-Seidel and SOR solvers, as in
``sublinear_tpu/solvers/jacobi.py``.

Jacobi is x <- D^-1 (b - R x) over ``op.offdiag_matvec`` (on the ``"csr"``
route the ``csr_spmv`` kernel), in blocks of ``check_every`` steps with one
residual read per block (``base.while_iterate``).

Gauss-Seidel and SOR are *multicolor*: a greedy coloring of the symmetrized
sparsity pattern is computed on the host once, and a sweep updates each
color class at once.  Rows of one color do not couple, so each class update
is an exact Gauss-Seidel update.  Each color costs one full
``offdiag_matvec`` and a ``torch.where`` over a static bool mask
``(num_colors, n)`` on the device: the JAX package's fixed point and
schedule, with ``matvec_count = k * num_colors``.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..config import to_device
from ..matrix import Matrix
from ..types import SolverOptions, SolverResult
from . import base

# below this size the coloring runs in the NumPy loop, above it in the
# native loop (the JAX package's switch); both give the same colors
NATIVE_COLORING_MIN_N = 2000


def _jacobi_run(op, b, x0, threshold, max_iters, check_every,
                norm_mode="l2", mode="residual", change_tol=0.0):
    inv_d = op.inv_diag

    def step(x):
        return inv_d * (b - op.offdiag_matvec(x))

    def residual_of(x):
        return base.device_norm(op.matvec(x) - b, norm_mode)

    return base.while_iterate(
        base.repeat_steps(step, check_every), residual_of, x0, threshold,
        max_iters, check_every, x_of=lambda x: x, mode=mode,
        change_tol=change_tol)


def greedy_coloring(matrix: Matrix) -> np.ndarray:
    """Greedy graph coloring of the symmetrized sparsity pattern (host-side,
    O(nnz)).  Rows of the same color have no mutual coupling, so a GS update
    of one color class is exact and parallel."""
    csr = matrix.csr
    n = csr.shape[0]
    t = matrix.T_csr()
    if n > NATIVE_COLORING_MIN_N and native.available():
        return native.greedy_coloring(csr.indptr, csr.indices, t.indptr,
                                      t.indices, n)
    colors = np.full(n, -1, dtype=np.int32)
    for i in range(n):
        banned = set()
        for idx in range(csr.indptr[i], csr.indptr[i + 1]):
            j = csr.indices[idx]
            if j != i and colors[j] >= 0:
                banned.add(int(colors[j]))
        for idx in range(t.indptr[i], t.indptr[i + 1]):
            j = t.indices[idx]
            if j != i and colors[j] >= 0:
                banned.add(int(colors[j]))
        c = 0
        while c in banned:
            c += 1
        colors[i] = c
    return colors


def color_masks(colors: np.ndarray, n: int, device) -> torch.Tensor:
    """(num_colors, n) bool masks of the color classes of the n rows, on
    ``device``."""
    num_colors = int(colors.max()) + 1 if colors.size else 1
    masks = np.zeros((num_colors, n), dtype=bool)
    for c in range(num_colors):
        masks[c] = colors == c
    return to_device(masks, torch.bool, device)


def _sor_run(op, b, x0, masks, omega, threshold, max_iters, check_every,
             mode="residual", change_tol=0.0):
    inv_d = op.inv_diag

    def sweep(x):
        for mask in masks:
            gs = inv_d * (b - op.offdiag_matvec(x))
            x = torch.where(mask, (1.0 - omega) * x + omega * gs, x)
        return x

    def residual_of(x):
        return torch.linalg.vector_norm(op.matvec(x) - b)

    return base.while_iterate(
        base.repeat_steps(sweep, check_every), residual_of, x0, threshold,
        max_iters, check_every, x_of=lambda x: x, mode=mode,
        change_tol=change_tol)


def solve_jacobi(matrix: Matrix, b, options: SolverOptions,
                 raise_on_fail: bool = True) -> SolverResult:
    op, b_dev, x0, threshold = base.prepare(matrix, b, options)
    with base.SolveTimer(matrix.device) as t:
        x, k, res, change = _jacobi_run(
            op, b_dev, x0, threshold, options.max_iterations,
            options.check_every, base.norm_mode_of(options),
            base.driver_mode_of(options), options.epsilon)
    result = base.finalize(matrix, x, k, res, "jacobi", options, t.ms,
                           matvec_count=k)
    return base.check_outcome(result, threshold, options, raise_on_fail,
                              change=change)


def solve_sor(matrix: Matrix, b, options: SolverOptions, omega: float = 1.0,
              raise_on_fail: bool = True,
              method_name: str = "sor") -> SolverResult:
    op, b_dev, x0, threshold = base.prepare(matrix, b, options)
    colors = greedy_coloring(matrix)
    masks = color_masks(colors, op.shape[0], b_dev.device)
    # omega in the operator's dtype, as the JAX package passes it
    omega = float(torch.tensor(omega, dtype=op.dtype))
    with base.SolveTimer(matrix.device) as t:
        x, k, res, change = _sor_run(
            op, b_dev, x0, masks, omega, threshold, options.max_iterations,
            options.check_every, base.driver_mode_of(options),
            options.epsilon)
    result = base.finalize(matrix, x, k, res, method_name, options, t.ms,
                           matvec_count=k * masks.shape[0])
    return base.check_outcome(result, threshold, options, raise_on_fail,
                              change=change)


def solve_gauss_seidel(matrix: Matrix, b, options: SolverOptions,
                       raise_on_fail: bool = True) -> SolverResult:
    return solve_sor(matrix, b, options, omega=1.0,
                     raise_on_fail=raise_on_fail, method_name="gauss-seidel")
