"""Reverse Cuthill-McKee ordering on the host, in NumPy.

A copy of the NumPy breadth-first search that ``sublinear_tpu``'s native
``rcm_ordering`` falls back to (the C++ version runs the same algorithm):
components from the lowest-degree unvisited seed, neighbours visited in
(degree, index) order, the order reversed.  The port keeps its own copy
because it imports nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np


def rcm_ordering(indptr, indices, t_indptr, t_indices, n):
    """Reverse Cuthill-McKee permutation (perm[new] = old) over the
    symmetrized pattern of a CSR (``indptr``, ``indices``) and its transpose
    (``t_indptr``, ``t_indices``)."""
    indptr, indices = np.asarray(indptr), np.asarray(indices)
    t_indptr, t_indices = np.asarray(t_indptr), np.asarray(t_indices)
    degree = (indptr[1:] - indptr[:-1]) + (t_indptr[1:] - t_indptr[:-1])
    visited = np.zeros(n, dtype=bool)
    order = []
    for s in np.lexsort((np.arange(n), degree)):
        if visited[s]:
            continue
        visited[s] = True
        order.append(int(s))
        head = len(order) - 1
        while head < len(order):
            u = order[head]
            head += 1
            nbrs = np.concatenate([
                indices[indptr[u]:indptr[u + 1]],
                t_indices[t_indptr[u]:t_indptr[u + 1]],
            ])
            fresh = []
            for v in nbrs:
                v = int(v)
                if v != u and not visited[v]:
                    visited[v] = True
                    fresh.append(v)
            fresh.sort(key=lambda v: (degree[v], v))
            order.extend(fresh)
    return np.asarray(order[::-1], dtype=np.int64)
