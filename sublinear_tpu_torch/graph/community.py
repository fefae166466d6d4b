"""Community detection and modularity, a copy of
``sublinear_tpu/graph/community.py``: host NumPy, no device work.

Reference: GraphTools.detectCommunities (src/mcp/tools/graph.ts:208-248)
assigns communities round-robin over PageRank-sorted nodes and scores them
with Newman modularity (:369-384).  Both packages keep that API and result
shape but assign by synchronous weighted label propagation; for one
``seed`` the port's assignments are bit-identical to the JAX package's.
"""
from __future__ import annotations

import numpy as np

from ..matrix import Matrix


def modularity(adjacency: Matrix, assignments: np.ndarray) -> float:
    """Newman modularity, matching graph.ts:369-384 (directed degrees)."""
    csr = adjacency.csr
    n = csr.shape[0]
    r, c, v = csr.to_coo()
    m = v.sum() / 2.0
    if m <= 0:
        return 0.0
    deg = np.zeros(n)
    np.add.at(deg, r, v)
    same = assignments[r] == assignments[c]
    lhs = v[same].sum()
    # expected term: sum over same-community pairs of k_i k_j / 2m
    q = 0.0
    for comm in np.unique(assignments):
        dk = deg[assignments == comm].sum()
        q -= dk * dk / (2.0 * m)
    return float((lhs + q) / (2.0 * m))


def label_propagation(adjacency: Matrix, max_iterations: int = 50, seed: int = 0) -> np.ndarray:
    """Synchronous weighted label propagation (host numpy — O(nnz) per sweep)."""
    csr = adjacency.csr
    n = csr.shape[0]
    r, c, v = csr.to_coo()
    off = r != c
    r, c, v = r[off], c[off], np.abs(v[off])
    labels = np.arange(n)
    rng = np.random.default_rng(seed)
    for _ in range(max_iterations):
        # per node, pick the incident label with max total weight
        # build (node, neighbor_label) weights
        nl = labels[c]
        keys = r * n + nl
        uniq, inv = np.unique(keys, return_inverse=True)
        w = np.zeros(uniq.size)
        np.add.at(w, inv, v)
        nodes = uniq // n
        labs = uniq % n
        # argmax per node with random tie-break
        order = np.lexsort((rng.random(uniq.size), w))
        best = np.full(n, -1, dtype=np.int64)
        best[nodes[order]] = labs[order]  # last write wins = max weight
        new_labels = np.where(best >= 0, best, labels)
        if np.array_equal(new_labels, labels):
            break
        labels = new_labels
    # compact label ids
    _, compact = np.unique(labels, return_inverse=True)
    return compact


def detect_communities(adjacency: Matrix, num_communities: int | None = None, seed: int = 0) -> dict:
    n = adjacency.shape[0]
    assignments = label_propagation(adjacency, seed=seed)
    found = int(assignments.max()) + 1 if n else 0
    if num_communities is not None and found > num_communities:
        # merge smallest communities into nearest by size (simple fold)
        sizes = np.bincount(assignments)
        order = np.argsort(-sizes)
        remap = np.zeros(found, dtype=np.int64)
        for rank, comm in enumerate(order):
            remap[comm] = min(rank, num_communities - 1)
        assignments = remap[assignments]
        found = int(assignments.max()) + 1
    communities = [np.nonzero(assignments == k)[0].tolist() for k in range(found)]
    sizes = [len(c) for c in communities] or [0]
    return {
        "communities": communities,
        "assignments": assignments.tolist(),
        "modularity": modularity(adjacency, assignments),
        "quality": {
            "numCommunities": found,
            "largestCommunity": max(sizes),
            "smallestCommunity": min(sizes),
        },
    }
