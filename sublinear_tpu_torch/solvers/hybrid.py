"""Hybrid solver: push, then random-walk refinement, then a Krylov polish,
as in ``sublinear_tpu/solvers/hybrid.py``.

The reference's three-phase HybridSolver: (1) forward push in chunks, with
the phase switch on the improvement rate over a convergence window; (2)
random-walk refinement with a decaying blend 0.3 * (1 - round / rounds) and
global-best tracking; (3) a CG (symmetric) or BiCGSTAB polish from the best
iterate.  Each phase chunk runs on the device through the port's push,
random-walk and Krylov solvers; the host checks the improvement rate
between chunks.  The walker phase runs at any n: the walkers are chunked to
the device budget by ``random_walk.run_walks``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..matrix import Matrix
from ..types import SolverOptions, SolverResult
from . import base, cg as _cg, push as _push

# reference HybridConfig defaults (hybrid.rs:24-72)
MIN_PHASE_ITERS = 2      # chunks, not raw iterations
IMPROVEMENT_THRESHOLD = 0.05
CONVERGENCE_WINDOW = 2   # compare across this many chunk residuals
PUSH_CHUNK = 8           # on-device iterations per host-visible chunk
MC_MAX_ROUNDS = 4
MC_BLEND0 = 0.3          # hybrid.rs:263 blend factor


def _improvement_rate(history: list) -> float:
    if len(history) < CONVERGENCE_WINDOW + 1:
        return float("inf")
    start = history[-1 - CONVERGENCE_WINDOW]
    end = history[-1]
    return (start - end) / start if start > 0 else 0.0


def solve_hybrid(matrix: Matrix, b, options: SolverOptions, raise_on_fail: bool = True) -> SolverResult:
    threshold = base.threshold_for(b, options)
    phases = []
    n = matrix.shape[0]
    b64 = np.asarray(b, dtype=np.float64)

    def residual_of(x):
        return float(np.linalg.norm(matrix.csr.matvec(x) - b64))

    # ---- Phase 1: frontier push in chunks, improvement-rate switching
    # (hybrid.rs:221-248 + should_switch_phase :350-376)
    max_push = max(options.max_iterations // 2, PUSH_CHUNK)
    history = []
    x = None
    iters = 0
    switch_reason = "budget"
    while iters < max_push:
        chunk_opts = dataclasses.replace(
            options, max_iterations=PUSH_CHUNK, x0=x
        )
        p = _push.solve_push(matrix, b, chunk_opts, direction="forward-push", raise_on_fail=False)
        x = p.solution
        iters += p.iterations if p.iterations else PUSH_CHUNK
        history.append(p.residual)
        if p.converged:
            switch_reason = "converged"
            break
        if len(history) >= MIN_PHASE_ITERS and _improvement_rate(history) < IMPROVEMENT_THRESHOLD:
            switch_reason = "improvement-rate"
            break
    best_x, best_res = x, history[-1]
    phases.append({
        "phase": "push", "iterations": iters, "residual": best_res,
        "switch_reason": switch_reason, "history": [float(h) for h in history],
    })
    if best_res <= threshold:
        return SolverResult(
            solution=best_x, iterations=iters, residual=best_res,
            converged=True, method="hybrid", phases=phases,
        )

    # ---- Phase 2: random-walk refinement with decaying blend
    # (hybrid.rs:251-279); any n — walkers are lane-parallel
    if best_res > 1e3 * threshold:
        from . import random_walk as _rw

        rw_opts = dataclasses.replace(options, num_walks=64)
        mc_history = []
        blends = []
        mixed = best_x
        reason = "budget"
        for it in range(MC_MAX_ROUNDS):
            est, _, steps = _rw.walk_estimate(matrix, b, np.arange(n), rw_opts)
            blend = MC_BLEND0 * (1.0 - it / MC_MAX_ROUNDS)  # decaying blend
            blends.append(blend)
            mixed = (1.0 - blend) * mixed + blend * est
            res_mixed = residual_of(mixed)
            mc_history.append(res_mixed)
            if res_mixed < best_res:  # global-best tracking (hybrid.rs:383-389)
                best_x, best_res = mixed, res_mixed
            if len(mc_history) >= MIN_PHASE_ITERS and _improvement_rate(mc_history) < IMPROVEMENT_THRESHOLD:
                reason = "improvement-rate"
                break
        phases.append({
            "phase": "random-walk", "iterations": len(mc_history),
            "residual": best_res, "blends": blends,
            "switch_reason": reason, "history": mc_history,
        })

    # ---- Phase 3: Krylov polish from the global best iterate (hybrid.rs:283-327)
    polish_opts = dataclasses.replace(options, x0=best_x)
    from ..analysis import analyze

    sym = analyze(matrix, estimate_condition=False).is_symmetric
    p3 = (
        _cg.solve_cg(matrix, b, polish_opts, raise_on_fail=raise_on_fail)
        if sym
        else _cg.solve_bicgstab(matrix, b, polish_opts, raise_on_fail=raise_on_fail)
    )
    phases.append({"phase": "krylov", "iterations": p3.iterations, "residual": p3.residual})

    p3.method = "hybrid"
    p3.iterations += iters
    p3.memory_used = 0
    p3.phases = phases
    return p3
