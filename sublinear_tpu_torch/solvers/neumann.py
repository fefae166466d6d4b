"""Truncated Neumann-series solver, as in ``sublinear_tpu/solvers/neumann.py``.

With A = D + R_off, the iteration matrix is M = I - D^-1 A and

    x = sum_k M^k D^-1 b,   term_{k+1} = -D^-1 R_off term_k

(the reference's Rust form, src/solver/neumann.rs:252-299).  Warm restart is
the series on the residual b - A x0, added to x0.  The iteration runs on the
operator's device; the host loop in ``base.while_iterate`` checks the
residual once per ``check_every`` chunk.

CUDA graphs.  Run eagerly, a solve issues some 25 small device operations
one at a time from Python (the prelude; per chunk the chain's wrapper, two
elementwise passes and the residual; the tail), each a few microseconds of
device work behind tens of microseconds of host dispatch.  Where that work
has fixed shapes and pointers, ``solve_neumann`` replays it instead, from
two CUDA graphs per chain-ready operator and (dtype, chunk length), kept on
the Matrix (``_Replay``).  The graphs record the eager path's own functions
over buffers that the capture leaves in place:

  prelude  ``base.prepare_on_device`` from b in a float64 buffer (which
           ``config.copy_to_device`` fills), then ``_series`` and the
           first residual;
  chunk    ``_step_block`` and the residual, the new state copied back into
           the buffers the chunk reads.

The host then runs ``base.while_iterate`` and ``_tail`` as the eager path
does, with a replay of the chunk for each step block.  The kernels and
their arithmetic are the eager path's, so the answers are bit-equal, and
the host issues one replay for the prelude and one per chunk.

The graphs serve a call on a CUDA operator that ``base.chained`` accepts,
under the l2 residual rule with a relative threshold and no x0.  Every
other call (``PreparedSolver``, ``solve_batch``'s per-column path, the
timeout path's warm restarts, the change-based modes, the l1 and max norms,
an absolute threshold, the DIA, ELL and dense routes, the CPU) runs the
eager path.  So does an operator's first such solve, which builds what the
operator builds lazily (row blocks, the kernels' library, the chain's
grid); the next one captures both graphs and replays them.

Each ``_Replay`` captures on a stream of its own, on its operator's device,
and one capture runs at a time in the process (``_CAPTURE_LOCK``); replays
run on the current stream of the operator's device.  One solve at a time
holds a ``_Replay`` (its lock is taken without waiting); a call that finds
it held runs the eager path.  The solution leaves the graph's buffer through
``config.to_host`` before the lock is released.  Counters: the kernels'
wrappers list what a capture launches (``ops/csr_spmv.py::recording``) and
each replay counts that list (``replayed``), so every counter of a solve
reads what the eager path's does; a capture counts
``neumann_graph_captures`` and each replayed chunk ``neumann_graph_chunks``.
"""
from __future__ import annotations

import math
import threading

import numpy as np
import torch

from .. import tracing
from ..config import copy_to_device, host_float, resolve_dtype
from ..matrix import Matrix
from ..ops.csr_spmv import recording, replayed
from ..types import SolverOptions, SolverResult
from . import base


def _series(op, b, x0):
    """The series' first state, (x0 + term0, term0) with term0 = D^-1 (b -
    A x0): the warm restart's series on the residual, added to x0."""
    term0 = op.inv_diag * (b - op.matvec(x0))
    return x0 + term0, term0


def _step_block(op, check_every: int):
    """``while_iterate``'s step block: ``check_every`` Neumann steps from
    the state (x, term)."""
    if base.chained(op, check_every):
        # one chunk = check_every Neumann iterations as one chain of
        # neumann_step kernels (ops/csr_spmv.py)
        def step_block(state):
            x, term = state
            acc, term2 = op.neumann_chain(term, check_every)
            return x + (acc - term), term2
    else:
        inv_d = op.inv_diag

        def step_block(state):
            x, term = state
            for _ in range(check_every):
                term = -inv_d * op.offdiag_matvec(term)
                x = x + term
            return x, term
    return step_block


def _residual_of(op, b, norm_mode: str):
    """``while_iterate``'s residual: the norm of A x - b for the state's x."""
    def residual_of(state):
        return base.device_norm(op.matvec(state[0]) - b, norm_mode)
    return residual_of


def _tail(term, term0):
    """The geometric tail's data for the truncation error bound, ||term||
    and ||term0|| (reference: src/solver/neumann.rs:321-347)."""
    return (host_float(torch.linalg.vector_norm(term)),
            host_float(torch.linalg.vector_norm(term0)))


def _neumann_run(op, b, x0, threshold, max_iters, check_every, norm_mode="l2", mode="residual", change_tol=0.0):
    state0 = _series(op, b, x0)
    (state, k, res, change) = base.while_iterate(
        _step_block(op, check_every), _residual_of(op, b, norm_mode), state0,
        threshold, max_iters, check_every, x_of=lambda st: st[0], mode=mode,
        change_tol=change_tol,
    )
    return (state[0], k, res, change, *_tail(state[1], state0[1]))


# one capture at a time in the process
_CAPTURE_LOCK = threading.Lock()


class _Replay:
    """The CUDA graphs of one chain-ready operator and chunk length, the
    buffers they read and write, and the lock of the solve that uses them
    (the module's docstring)."""

    def __init__(self, op, check_every: int):
        self.op, self.every = op, check_every
        self.lock = threading.Lock()
        self.stream = torch.cuda.Stream(device=op.device)
        self.b64 = torch.zeros(op.shape[0], dtype=torch.float64,
                               device=op.device)
        self.warm = False    # an eager solve has run on the operator
        self.graphs = None   # (prelude, chunk) once captured

    def _capture(self, matrix: Matrix, options: SolverOptions):
        op, graphs = self.op, (torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph())

        def graph(g):
            return torch.cuda.graph(g, stream=self.stream,
                                    capture_error_mode="thread_local")

        with _CAPTURE_LOCK:
            with recording() as self.prelude_log, graph(graphs[0]):
                b, x0, threshold = base.prepare_on_device(
                    matrix, op, self.b64, options)
                residual_of = _residual_of(op, b, "l2")
                x, term0 = _series(op, b, x0)
                term = term0.clone()  # the chunk updates term in place
                res0 = residual_of((x, term))
            with recording() as self.chunk_log, graph(graphs[1]):
                new = _step_block(op, self.every)((x, term))
                res = residual_of(new)
                x.copy_(new[0])
                term.copy_(new[1])
        self.nb, self.term0 = threshold.norm, term0
        self.state0, self.state = (x, term, res0), (x, term, res)
        self.graphs = graphs
        tracing.count("neumann_graph_captures")

    def _chunk(self, state):
        self.graphs[1].replay()
        replayed(self.chunk_log)
        tracing.count("neumann_graph_chunks")
        return self.state

    def solve(self, matrix: Matrix, b, options: SolverOptions,
              raise_on_fail: bool) -> SolverResult:
        b = base.host_rhs(matrix, b)
        with torch.cuda.device(self.op.device):
            if self.graphs is None:
                self._capture(matrix, options)
            copy_to_device(b, self.b64)
            threshold = base.Threshold(self.nb, float(options.epsilon))
            with base.SolveTimer(matrix.device) as t:
                self.graphs[0].replay()
                replayed(self.prelude_log)
                state, k, res, _ = base.while_iterate(
                    self._chunk, lambda st: st[2], self.state0, threshold,
                    options.max_iterations, self.every)
                term_n, rhs_n = _tail(state[1], self.term0)
            return _outcome(matrix, state[0], k, res, math.inf, term_n, rhs_n,
                            threshold, options, t.ms, raise_on_fail)


def _on_card(op) -> bool:
    return op.device.type == "cuda"


def _replay_for(matrix: Matrix, options: SolverOptions):
    """The matrix's ``_Replay`` for this call's operator and chunk length
    (made on first use, under the matrix's lock), or None where the graphs
    do not serve the call (the module's docstring)."""
    if (options.x0 is not None or options.convergence == "absolute"
            or base.norm_mode_of(options) != "l2"
            or base.driver_mode_of(options) != "residual"):
        return None
    op = matrix.op(options.dtype)
    if not (base.chained(op, options.check_every) and _on_card(op)):
        return None
    key = (str(resolve_dtype(options.dtype)), options.check_every)
    replay = matrix._neumann_graphs.get(key)
    if replay is None:
        with matrix._lock:
            replay = matrix._neumann_graphs.get(key)
            if replay is None:
                replay = matrix._neumann_graphs[key] = _Replay(
                    op, options.check_every)
    return replay


def _outcome(matrix, x, k, res, change, term_n, rhs_n, threshold, options,
             ms, raise_on_fail) -> SolverResult:
    eb = base.neumann_truncation_bounds(matrix, k, term_n, rhs_n, res)
    result = base.finalize(
        matrix, x, k, res, "neumann", options, ms,
        matvec_count=int(np.ceil(k * (1 + 1 / max(options.check_every, 1)))),
        error_bounds=eb,
    )
    return base.check_outcome(result, threshold, options, raise_on_fail,
                              change=change)


def _solve_eager(matrix: Matrix, b, options: SolverOptions,
                 raise_on_fail: bool) -> SolverResult:
    op, b_dev, x0, threshold = base.prepare(matrix, b, options)
    with base.SolveTimer(matrix.device) as t:
        x, k, res, change, term_n, rhs_n = _neumann_run(
            op, b_dev, x0, threshold, options.max_iterations, options.check_every,
            base.norm_mode_of(options), base.driver_mode_of(options), options.epsilon,
        )
    return _outcome(matrix, x, k, res, change, term_n, rhs_n, threshold,
                    options, t.ms, raise_on_fail)


def solve_neumann(matrix: Matrix, b, options: SolverOptions, raise_on_fail: bool = True) -> SolverResult:
    replay = _replay_for(matrix, options)
    if replay is None or not replay.lock.acquire(blocking=False):
        return _solve_eager(matrix, b, options, raise_on_fail)
    try:
        if replay.warm:
            return replay.solve(matrix, b, options, raise_on_fail)
        result = _solve_eager(matrix, b, options, raise_on_fail)
        replay.warm = True
        return result
    finally:
        replay.lock.release()
