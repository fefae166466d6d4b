"""PreparedSolver: prepare once, solve many right-hand sides, as in
``sublinear_tpu/solvers/prepared.py``.

Preparation pins the device operator and resolves the method once; each
``solve(b)`` costs the RHS transfer and the solver loop, without the
per-call analysis and dispatch of ``solve()``.  The runners are the same
``_*_run`` functions ``solve()`` reaches for that method, with the same
choices: Neumann runs its chain (``neumann_chain``) and CG its chained
Jacobi-PCG (``cg_chain``) where the operator is chain-ready, so a prepared
solve and a plain ``solve()`` of one b take the same iterations.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..analysis import analyze
from ..errors import InvalidParametersError
from ..matrix import Matrix
from ..types import Method, SolverOptions, SolverResult, parse_method
from . import base


class PreparedSolver:
    def __init__(self, matrix: Matrix, method: str = "adaptive",
                 options: Optional[SolverOptions] = None):
        from .dispatch import select_method

        self.matrix = matrix
        self.options = options or SolverOptions()
        m = parse_method(method)
        if m == Method.ADAPTIVE:
            m = select_method(matrix)
        self.method = m
        self.op = matrix.op(self.options.dtype)
        self._runner = self._build_runner()
        # a first solve builds what the operator builds lazily (the row
        # blocks of the "csr" route)
        self.solve(np.zeros(matrix.shape[0]))

    def _build_runner(self):
        from . import cg as _cg
        from . import chebyshev as _cheb
        from . import jacobi as _jacobi
        from . import neumann as _neumann
        from . import push as _push

        opts = self.options
        m = self.method
        if m == Method.CG and not analyze(
                self.matrix, estimate_condition=False).is_symmetric:
            m = Method.BICGSTAB
        norm_mode = base.norm_mode_of(opts)
        its, every = opts.max_iterations, opts.check_every

        if m == Method.NEUMANN:
            return lambda op, b, x0, thr: _neumann._neumann_run(
                op, b, x0, thr, its, every, norm_mode)
        if m == Method.JACOBI:
            return lambda op, b, x0, thr: _jacobi._jacobi_run(
                op, b, x0, thr, its, every, norm_mode)
        if m == Method.CG:
            if getattr(self.op, "chain_ready", False) and every > 1:
                def chained(op, b, x0, thr):
                    x, k, res = _cg._cg_chain_run(op, b, x0, thr, its, every)
                    return x, k, res, math.inf
                return chained
            return lambda op, b, x0, thr: _cg._cg_run(op, b, x0, thr, its,
                                                      True)
        if m == Method.BICGSTAB:
            return lambda op, b, x0, thr: _cg._bicgstab_run(op, b, x0, thr,
                                                            its)
        if m in (Method.FORWARD_PUSH, Method.BACKWARD_PUSH):
            return lambda op, b, x0, thr: _push._push_run(
                op, b, x0, thr, its, every, norm_mode)
        if m == Method.CHEBYSHEV:
            rho = min(max(float(analyze(self.matrix, estimate_condition=False)
                                .spectral_radius_estimate or 0.9), 1e-3), 0.999)
            return lambda op, b, x0, thr: _cheb._chebyshev_run(
                op, b, x0, rho, thr, its, every, norm_mode)
        raise InvalidParametersError(
            f"PreparedSolver supports direct iterative methods, not {m}"
        )

    def solve(self, b, x0: Optional[np.ndarray] = None) -> SolverResult:
        opts = self.options
        b_pad = self.matrix.pad_vector(b, opts.dtype)
        x0_pad = (self.matrix.pad_vector(x0, opts.dtype) if x0 is not None
                  else torch.zeros_like(b_pad))
        threshold = base.threshold_for(b, opts)
        with base.SolveTimer(self.matrix.device) as t:
            out = self._runner(self.op, b_pad, x0_pad, threshold)
            x, k, res = out[0], out[1], out[2]  # runners return (..., change)
        result = base.finalize(self.matrix, x, k, res, self.method.value,
                               opts, t.ms, matvec_count=int(k))
        return base.check_outcome(result, threshold, opts, raise_on_fail=False)
