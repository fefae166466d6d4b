"""Mixed-precision iterative refinement, as in ``sublinear_tpu/solvers/refine.py``.

Plain f32 solves floor at ~2e-7 relative residual.  Classic iterative
refinement reaches f64-grade residuals:

    repeat:  r = b - A x      (f64)
             solve A d = r    (f32 solve on the card)
             x = x + d        (f64 accumulation)

``residual="device"`` evaluates ``b - A x`` in f64 on the card: the CSR in
f64 (int64 row ids and column indices, f64 values) with a torch gather and a
segment sum (``index_add_``), and accumulates x in f64 on the card.  The
JAX package emulates f64 with compensated double-float pairs because the
TPU has no f64; the H100 has it, so the port does not.  ``residual="host"``
keeps the host f64 CSR product.  On the CPU both take the host path, as the
JAX package does off the TPU.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..config import host_float, to_device, to_host
from ..errors import ConvergenceError
from ..matrix import Matrix
from ..types import SolverOptions, SolverResult
from .dispatch import solve


class DeviceResidual:
    """b - A x in f64 on ``matrix``'s device (the full A, diagonal
    included)."""

    def __init__(self, matrix: Matrix, b64: np.ndarray):
        csr, dev = matrix.csr, matrix.device
        self.n = csr.shape[0]
        self.rows = to_device(csr.row_of_entry(), torch.int64, dev)
        self.cols = to_device(csr.indices, torch.int64, dev)
        self.vals = to_device(csr.data, torch.float64, dev)
        self.b = to_device(b64, torch.float64, dev)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        ax = torch.zeros(self.n, dtype=torch.float64, device=x.device)
        ax.index_add_(0, self.rows, self.vals * x[self.cols])
        return self.b - ax


def solve_refined(
    matrix: Matrix,
    b,
    options: Optional[SolverOptions] = None,
    method: Optional[str] = None,
    max_refinements: int = 4,
    raise_on_fail: bool = True,
    residual: str = "device",
) -> SolverResult:
    """Solve to ``options.epsilon`` in f64-exact residual terms.

    ``residual="device"`` evaluates the exact residual on the card in f64;
    ``"host"`` keeps the host f64 CSR matvec."""
    options = options or SolverOptions()
    b64 = np.asarray(b, dtype=np.float64).reshape(-1)
    nb = max(float(np.linalg.norm(b64)), 1e-300)
    target_abs = (float(options.epsilon) * nb
                  if options.convergence == "relative"
                  else float(options.epsilon))

    # inner f32 solves run to their own floor (slightly looser inner epsilon)
    inner = dataclasses.replace(options, convergence="relative",
                                epsilon=max(options.epsilon, 1e-6), x0=None)
    use_device = residual == "device" and matrix.device.type == "cuda"

    t0 = time.perf_counter()
    total_iters = 0
    inner_method = method
    residual_val = float("inf")
    if use_device:
        resid = DeviceResidual(matrix, b64)
        x_dev = torch.zeros(matrix.shape[0], dtype=torch.float64,
                            device=matrix.device)
        for _ in range(max_refinements + 1):
            r_dev = resid(x_dev)
            residual_val = host_float(torch.linalg.vector_norm(r_dev))
            if residual_val <= target_abs:
                break
            result = solve(matrix, to_host(r_dev), inner,
                           method=inner_method, raise_on_fail=False)
            inner_method = result.method if inner_method is None else inner_method
            total_iters += result.iterations
            if not np.all(np.isfinite(result.solution)):
                break
            x_dev += to_device(result.solution, torch.float64, matrix.device)
        x = to_host(x_dev)
    else:
        x = np.zeros_like(b64)
        for _ in range(max_refinements + 1):
            r = b64 - matrix.csr.matvec(x)  # exact f64 residual
            residual_val = float(np.linalg.norm(r))
            if residual_val <= target_abs:
                break
            result = solve(matrix, r, inner, method=inner_method,
                           raise_on_fail=False)
            inner_method = result.method if inner_method is None else inner_method
            total_iters += result.iterations
            if not np.all(np.isfinite(result.solution)):
                break
            x = x + result.solution

    out = SolverResult(
        solution=x,
        iterations=total_iters,
        residual=residual_val,
        converged=residual_val <= target_abs * 1.0000001,
        method=f"refined({inner_method})",
        compute_time_ms=(time.perf_counter() - t0) * 1e3,
    )
    if not out.converged and raise_on_fail:
        raise ConvergenceError(
            f"iterative refinement stalled at residual {residual_val:.3e} "
            f"(target {target_abs:.3e})",
            {"residual": residual_val, "target": target_abs,
             "iterations": total_iters},
        )
    return out
