"""PageRank and personalized PageRank, as in ``sublinear_tpu/graph/pagerank.py``.

Reference: ``SublinearSolver.computePageRank`` (src/core/solver.ts:664-722)
solves (I - alpha P^T) x = (1-alpha) v; ``GraphTools.pageRank``
(src/mcp/tools/graph.ts:22-92) adds ranking statistics.  Defaults: damping
0.85, epsilon 1e-6, max_iterations 1000.

The system is solved by the power (Richardson) iteration

    x <- (1-alpha) v + alpha (P^T x + dangling_mass(x) v)

the Neumann series of the PageRank system.  The column-stochastic P^T and
the out-degrees are host NumPy passes, once per adjacency and dtype; P^T is
then packed as a device operator (for a large sparse graph the ``"csr"``
route, so each step's product is one ``csr_spmv`` launch), and the operator
and the dangling-node mask stay on the adjacency ``Matrix`` for its later
calls.  Only the teleport vector is built per call.  The iteration
runs on ``base.while_iterate`` in blocks of ``check_every = 5`` steps, as
the JAX package's ``lax.while_loop`` does: each block enqueues its 5 steps
and the residual ||step(x) - x|| (one more product) and reads that one
number back.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..config import resolve_dtype, to_device, to_host
from ..errors import InvalidParametersError
from ..matrix import Matrix
from ..solvers import base

CHECK_EVERY = 5  # steps per read of the residual, as the JAX package


@dataclasses.dataclass
class PageRankResult:
    scores: np.ndarray
    iterations: int
    residual: float
    converged: bool
    damping: float
    personalized: bool = False

    def to_dict(self) -> dict:
        return {
            "pageRankVector": self.scores.tolist(),
            "iterations": self.iterations,
            "residual": self.residual,
            "converged": self.converged,
            "damping": self.damping,
            "personalized": self.personalized,
        }


def _out_degrees(csr) -> np.ndarray:
    out_deg = np.zeros(csr.shape[0])
    np.add.at(out_deg, csr.row_of_entry(), csr.data)
    return out_deg


@tracing.traced("slt.pagerank.transition")
def _transition_matrix(adjacency: Matrix, out_deg=None) -> Matrix:
    """Column-stochastic P^T as a Matrix on the adjacency's device (host
    side, one O(nnz) pass), with the adjacency's operator preference (P^T
    has its pattern, transposed).  ``out_deg``: the adjacency's row sums,
    where the caller has them."""
    csr = adjacency.csr
    if out_deg is None:
        out_deg = _out_degrees(csr)
    safe = np.where(out_deg > 0, out_deg, 1.0)
    # P[i, j] = a_ij / outdeg_i ; we store P^T so matvec(P^T, x) is row-form
    r, c, v = csr.to_coo()
    return Matrix.from_coo(c, r, v / safe[r], (csr.shape[1], csr.shape[0]),
                           prefer=adjacency._prefer, device=adjacency.device)


def _transition_inputs(adjacency: Matrix, dtype):
    """(P^T's device operator, the dangling-node mask) of ``adjacency`` in
    ``dtype``: built on the first call and kept in ``adjacency._pagerank``,
    so they die with the matrix.  Like its operators, they hold because a
    Matrix's ``csr`` is not mutated after construction."""
    key = str(resolve_dtype(dtype))
    entry = adjacency._pagerank.get(key)
    if entry is None:
        with adjacency._lock:
            entry = adjacency._pagerank.get(key)
            if entry is None:
                out_deg = _out_degrees(adjacency.csr)
                opT = _transition_matrix(adjacency, out_deg).op(dtype)
                entry = (opT, to_device(out_deg == 0, torch.bool,
                                        adjacency.device))
                adjacency._pagerank[key] = entry
                tracing.count("pagerank_transition_builds")
                return entry
    tracing.count("pagerank_transition_hits")
    return entry


@tracing.traced("slt.pagerank.inputs")
def pagerank_inputs(adjacency: Matrix, personalized=None, dtype=None):
    """The host set-up of one PageRank call: (P^T's device operator, the
    teleport vector v, the dangling-node mask), on the adjacency's device.
    The operator and the mask are the adjacency's own after its first call
    in ``dtype`` (``_transition_inputs``); v is built and uploaded here."""
    n = adjacency.shape[0]
    opT, dangling = _transition_inputs(adjacency, dtype)

    if personalized is not None:
        v = np.asarray(personalized, dtype=np.float64).reshape(-1)
        if v.size != n:
            raise InvalidParametersError("personalization vector length mismatch")
        s = v.sum()
        v = v / s if s > 0 else np.full(n, 1.0 / n)
    else:
        v = np.full(n, 1.0 / n)

    return opT, to_device(v, opT.dtype, adjacency.device), dangling


@tracing.traced("slt.pagerank.run")
def pagerank_run(opT, v, dangling_mask, alpha, threshold, max_iters,
                 check_every=CHECK_EVERY):
    """The power iteration from x = v: returns (x / sum(x), steps, residual)
    with x a tensor on v's device and the other two host numbers."""
    alpha = torch.tensor(alpha, dtype=v.dtype, device=v.device)
    teleport = (1.0 - alpha) * v

    def step(x):
        dangling = torch.sum(torch.where(dangling_mask, x, 0.0))
        return teleport + alpha * (opT.matvec(x) + dangling * v)

    def residual_of(x):
        return torch.linalg.vector_norm(step(x) - x)

    x, k, res, _ = base.while_iterate(
        base.repeat_steps(step, check_every), residual_of, v, threshold,
        max_iters, check_every)
    return x / torch.clamp(torch.sum(x), min=1e-30), k, res


def pagerank(
    adjacency: Matrix,
    damping: float = 0.85,
    personalized: Optional[np.ndarray] = None,
    epsilon: float = 1e-6,
    max_iterations: int = 1000,
    dtype=None,
) -> PageRankResult:
    if not adjacency.is_square():
        raise InvalidParametersError("Adjacency matrix must be square")
    if not (0.0 < damping < 1.0):
        raise InvalidParametersError(f"damping must be in (0,1), got {damping}")
    opT, v, dangling = pagerank_inputs(adjacency, personalized, dtype)
    x, k, res = pagerank_run(opT, v, dangling, damping, float(epsilon),
                             int(max_iterations))
    return PageRankResult(
        scores=to_host(x, np.float64),
        iterations=int(k),
        residual=res,
        converged=bool(res <= epsilon * 1.0000001),
        damping=damping,
        personalized=personalized is not None,
    )


def personalized_pagerank(
    adjacency: Matrix, personalize_nodes, **kwargs
) -> PageRankResult:
    """Reference: GraphTools.personalizedPageRank (graph.ts:93-123)."""
    n = adjacency.shape[0]
    nodes = np.asarray(personalize_nodes, dtype=np.int64).reshape(-1)
    if nodes.size == 0 or nodes.min() < 0 or nodes.max() >= n:
        raise InvalidParametersError("personalization nodes out of bounds")
    v = np.zeros(n)
    v[nodes] = 1.0 / nodes.size
    return pagerank(adjacency, personalized=v, **kwargs)


def pagerank_statistics(result: PageRankResult, top_k: int = 10) -> dict:
    """Ranking/statistics block mirroring graph.ts:45-88."""
    scores = result.scores
    order = np.argsort(-scores)
    total = float(scores.sum())
    mean = total / max(scores.size, 1)
    var = float(np.mean((scores - mean) ** 2))
    pos = scores[scores > 0]
    entropy = float(-(pos * np.log(pos)).sum()) if pos.size else 0.0
    qs = {f"q{int(q * 100)}": float(np.quantile(scores, q)) for q in (0.1, 0.25, 0.5, 0.75, 0.9)}
    k10 = max(1, int(np.ceil(scores.size * 0.1)))
    return {
        "topNodes": [{"node": int(i), "score": float(scores[i])} for i in order[:top_k]],
        "bottomNodes": [{"node": int(i), "score": float(scores[i])} for i in order[-top_k:][::-1]],
        "statistics": {
            "totalScore": total,
            "maxScore": float(scores.max()) if scores.size else 0.0,
            "minScore": float(scores.min()) if scores.size else 0.0,
            "mean": mean,
            "standardDeviation": float(np.sqrt(var)),
            "entropy": entropy,
            "convergenceInfo": {"damping": result.damping, "personalized": result.personalized},
        },
        "distribution": {
            "quantiles": qs,
            "concentrationRatio": float(scores[order[:k10]].sum() / total) if total > 0 else 0.0,
        },
    }
