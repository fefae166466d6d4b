"""PageRank and personalized PageRank, as in ``sublinear_tpu/graph/pagerank.py``.

Reference: ``SublinearSolver.computePageRank`` (src/core/solver.ts:664-722)
solves (I - alpha P^T) x = (1-alpha) v; ``GraphTools.pageRank``
(src/mcp/tools/graph.ts:22-92) adds ranking statistics.  Defaults: damping
0.85, epsilon 1e-6, max_iterations 1000.

The system is solved by the power (Richardson) iteration

    x <- (1-alpha) v + alpha (P^T x + dangling_mass(x) v)

the Neumann series of the PageRank system.  The column-stochastic P^T and
the out-degrees are host NumPy passes, once per call; P^T is then packed
as the matrix's device operator (for a large sparse graph the ``"csr"``
route, so each step's product is one ``csr_spmv`` launch).  The iteration
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

from ..config import to_device
from ..errors import InvalidParametersError
from ..formats.ell import pad_vector
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


def _transition_matrix(adjacency: Matrix) -> Matrix:
    """Column-stochastic P^T as a Matrix on the adjacency's device (host
    side, one O(nnz) pass)."""
    csr = adjacency.csr
    out_deg = np.zeros(csr.shape[0])
    rows = csr.row_of_entry()
    np.add.at(out_deg, rows, csr.data)
    safe = np.where(out_deg > 0, out_deg, 1.0)
    # P[i, j] = a_ij / outdeg_i ; we store P^T so matvec(P^T, x) is row-form
    r, c, v = csr.to_coo()
    return Matrix.from_coo(c, r, v / safe[r], (csr.shape[1], csr.shape[0]),
                           device=adjacency.device)


def pagerank_inputs(adjacency: Matrix, personalized=None, dtype=None):
    """The host set-up of one PageRank call: (P^T's device operator, the
    teleport vector v, the dangling-node mask), on the adjacency's
    device."""
    n = adjacency.shape[0]
    PT = _transition_matrix(adjacency)
    opT = PT.op(dtype)

    if personalized is not None:
        v = np.asarray(personalized, dtype=np.float64).reshape(-1)
        if v.size != n:
            raise InvalidParametersError("personalization vector length mismatch")
        s = v.sum()
        v = v / s if s > 0 else np.full(n, 1.0 / n)
    else:
        v = np.full(n, 1.0 / n)

    out_deg = np.zeros(n)
    rows = adjacency.csr.row_of_entry()
    np.add.at(out_deg, rows, adjacency.csr.data)
    dangling = np.zeros(opT.n_pad, dtype=bool)
    dangling[:n] = out_deg == 0

    dev = adjacency.device
    return (opT, pad_vector(v, opT.n_pad, opT.dtype, dev),
            to_device(dangling, torch.bool, dev))


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
    n = adjacency.shape[0]
    opT, v, dangling = pagerank_inputs(adjacency, personalized, dtype)
    x, k, res = pagerank_run(opT, v, dangling, damping, float(epsilon),
                             int(max_iterations))
    return PageRankResult(
        scores=x.cpu().double().numpy()[:n],
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
