"""Social-network workloads: opinion dynamics and influence propagation, as
in ``sublinear_tpu/graph/social.py``.

Reference: scripts/social_networks/ (influence propagation, opinion
dynamics over GML fixtures).

  - Friedkin-Johnsen opinion dynamics is a DD solve,
        x = (I - (1-s) W)^-1 s x0   (s = susceptibility to own prior),
    a Neumann solve (on the ``"csr"`` route the ``neumann_step`` chain).
  - DeGroot consensus is the power iteration x <- W x: a host loop that
    enqueues ``steps`` products (``csr_spmv`` launches on the ``"csr"``
    route) and reads the result once, where the JAX package runs a
    ``fori_loop``.
  - Influence propagation: personalized-PageRank mass from seed nodes.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..matrix import Matrix
from ..solvers.dispatch import solve
from ..types import SolverOptions
from .pagerank import personalized_pagerank


def row_normalize(adjacency: Matrix) -> Matrix:
    csr = adjacency.csr
    n = csr.shape[0]
    rows = csr.row_of_entry()
    deg = np.zeros(n)
    np.add.at(deg, rows, np.abs(csr.data))
    safe = np.where(deg > 0, deg, 1.0)
    r, c, v = csr.to_coo()
    return Matrix.from_coo(r, c, v / safe[r], (n, n), device=adjacency.device)


def friedkin_johnsen(
    adjacency: Matrix,
    initial_opinions,
    susceptibility: float = 0.5,
    epsilon: float = 1e-6,  # f32 relative-residual floor is ~2e-7
) -> dict:
    """x = (I - (1-s) W)^-1 s x0 — strictly DD for s > 0."""
    n = adjacency.shape[0]
    x0 = np.asarray(initial_opinions, dtype=np.float64).reshape(-1)
    W = row_normalize(adjacency)
    r, c, v = W.csr.to_coo()
    lam = 1.0 - susceptibility
    d = np.arange(n)
    A = Matrix.from_coo(
        np.concatenate([r, d]), np.concatenate([c, d]),
        np.concatenate([-lam * v, np.ones(n)]), (n, n), device=adjacency.device,
    )
    result = solve(A, susceptibility * x0, SolverOptions(epsilon=epsilon, max_iterations=5000),
                   method="neumann", raise_on_fail=False)
    return {
        "opinions": result.solution.tolist(),
        "initialOpinions": x0.tolist(),
        "susceptibility": susceptibility,
        "polarization": float(np.var(result.solution)),
        "convergenceInfo": {"iterations": result.iterations, "residual": result.residual,
                            "converged": result.converged},
    }


def degroot_consensus(adjacency: Matrix, initial_opinions, steps: int = 100) -> dict:
    """x_{t+1} = W x_t on the device (consensus when W is primitive)."""
    W = row_normalize(adjacency)
    op = W.op()
    x = W.pad_vector(np.asarray(initial_opinions, dtype=np.float64))
    for _ in range(steps):
        x = op.matvec(x)
    out = x.cpu().double().numpy()[: adjacency.shape[0]]
    return {
        "opinions": out.tolist(),
        "consensusValue": float(out.mean()),
        "spread": float(out.max() - out.min()),
        "steps": steps,
    }


def influence_propagation(
    adjacency: Matrix,
    seeds: Sequence[int],
    damping: float = 0.85,
    top_k: int = 10,
) -> dict:
    """Influence reach of seed nodes via personalized PageRank mass."""
    result = personalized_pagerank(adjacency, list(seeds), damping=damping)
    scores = result.scores
    order = np.argsort(-scores)
    reached = order[: max(top_k, len(list(seeds)))]
    return {
        "seeds": list(map(int, seeds)),
        "influenceScores": scores.tolist(),
        "topInfluenced": [{"node": int(i), "score": float(scores[i])} for i in reached[:top_k]],
        "totalSeedInfluence": float(scores[list(seeds)].sum()),
        "converged": result.converged,
    }
