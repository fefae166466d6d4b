"""Centrality measures: PageRank, closeness, betweenness, as in
``sublinear_tpu/graph/centrality.py``.

Reference: GraphTools.computeCentralities (src/mcp/tools/graph.ts:187-205),
whose closeness and betweenness are ``Math.random()`` placeholders
(graph.ts:337-368); both packages compute the real measures on the device:

  - closeness: batched multi-source Bellman-Ford sweeps
    (``solvers/bmssp.py::batched_distances_device``), one chunk of 256
    sources at a time; the farness is reduced on the device and only (S, 2)
    numbers are read per chunk; closeness_i is the Wasserman-Faust
    normalized inverse farness;
  - betweenness: level-synchronous Brandes on the device.  Per chunk of
    sources the BFS levels stay on the device, the deepest level L is read
    once, and two host loops of L torch steps each run the sigma forward
    accumulation and the dependency back-propagation as gathers over the
    (n, K) in- and out-edge tables: an (n, K, S) tensor per gather, so
    memory grows with the chunk S.  The host BFS is the exact oracle.
"""
from __future__ import annotations

import numpy as np
import torch

from ..matrix import Matrix
from ..solvers.bmssp import INF, batched_distances_device, in_edge_tables
from .pagerank import pagerank

_TINY = 1e-30
CHUNK = 256  # sources per device sweep


def _unit_graph(adjacency: Matrix) -> Matrix:
    n = adjacency.shape[0]
    r, c, v = adjacency.csr.to_coo()
    off = r != c
    return Matrix.from_coo(r[off], c[off], np.ones(int(off.sum())), (n, n),
                           device=adjacency.device)


def closeness_centrality(adjacency: Matrix, nodes=None, unit_weights: bool = True) -> dict:
    n = adjacency.shape[0]
    g = _unit_graph(adjacency) if unit_weights else adjacency
    nodes = np.arange(n) if nodes is None else np.asarray(nodes, dtype=np.int64)
    closeness = np.zeros(n)
    for c0 in range(0, nodes.size, CHUNK):
        cs = nodes[c0 : c0 + CHUNK]
        dist = batched_distances_device(g, cs, unit_weights=unit_weights)
        reach = (dist < INF * 0.5) & torch.isfinite(dist)
        reach = reach & (torch.arange(dist.shape[0], device=dist.device)[:, None] < n)
        total = torch.sum(torch.where(reach, dist, 0.0), dim=0)
        reachable = torch.sum(reach, dim=0) - 1
        # the chunk's one read: S farness sums and S reach counts
        total, reachable = torch.stack(
            (total.double(), reachable.double())).cpu().numpy()
        for j, i in enumerate(cs):
            # Wasserman-Faust normalization for disconnected graphs
            closeness[i] = (
                (reachable[j] / (n - 1)) * (reachable[j] / total[j])
                if total[j] > 0 else 0.0
            )
    return {
        "closenessVector": closeness.tolist(),
        "normalized": (closeness / max(n - 1, 1)).tolist(),
    }


# ------------------------------------------------------------ device Brandes

def _gather(t: torch.Tensor, idx_flat: torch.Tensor, K: int) -> torch.Tensor:
    """Rows ``idx`` of the (n_pad, S) tensor ``t`` as (n_pad, K, S)."""
    return t.index_select(0, idx_flat).view(-1, K, t.shape[1])


def _brandes_chunk(in_srcs, in_mask, out_dsts, out_mask, dist, L: int):
    """sigma forward + dependency backward for one source chunk.

    dist: (n_pad, S) BFS levels (INF where unreachable; the batch axis is
    minor, so a gather pulls contiguous rows of S numbers), L: the deepest
    finite level.  Returns the per-node dependency sums (n_pad,).

    The predecessor and successor masks and the successors' sigma do not
    change across levels, so they are gathered once (the JAX package
    gathers them inside its loops); every sum and quotient is the JAX
    package's."""
    K_in, K_out = in_srcs.shape[1], out_dsts.shape[1]
    in_flat, out_flat = in_srcs.reshape(-1).long(), out_dsts.reshape(-1).long()
    sigma = torch.where(dist == 0.0, 1.0, 0.0).to(dist.dtype)

    pred = in_mask[:, :, None] & (_gather(dist, in_flat, K_in)
                                  == (dist[:, None, :] - 1.0))
    for level in range(1, L + 1):
        g_sig = _gather(sigma, in_flat, K_in)
        contrib = torch.sum(torch.where(pred, g_sig, 0.0), dim=1)
        sigma = torch.where(dist == float(level), contrib, sigma)
    del pred

    succ = out_mask[:, :, None] & (_gather(dist, out_flat, K_out)
                                   == (dist[:, None, :] + 1.0))
    g_sig = torch.clamp(_gather(sigma, out_flat, K_out), min=_TINY)
    delta = torch.zeros_like(sigma)
    for level in range(L - 1, -1, -1):
        g_del = _gather(delta, out_flat, K_out)
        ratio = torch.sum(torch.where(succ, (1.0 + g_del) / g_sig, 0.0), dim=1)
        delta = torch.where(dist == float(level), sigma * ratio, delta)
    # accumulate only reachable non-source nodes
    contrib = torch.where((dist > 0.0) & (dist < INF * 0.5), delta, 0.0)
    return torch.sum(contrib, dim=1)


def betweenness_centrality(
    adjacency: Matrix, num_samples: int | None = None, seed: int = 0,
    backend: str = "auto", chunk: int = CHUNK,
) -> dict:
    """Brandes betweenness on the unweighted digraph.

    backend='device' (the default from n=192): batched level-synchronous
    Brandes on the matrix's device.  'host' is the exact oracle."""
    n = adjacency.shape[0]
    if backend == "auto":
        backend = "device" if n >= 192 else "host"
    rng = np.random.default_rng(seed)
    if num_samples is None or num_samples >= n:
        sources = np.arange(n)
        scale = 1.0
    else:
        sources = rng.choice(n, size=num_samples, replace=False)
        scale = n / num_samples

    if backend == "host":
        bc = _betweenness_host(adjacency, sources, scale)
    else:
        bc = _betweenness_device(adjacency, sources, scale, chunk)
    denom = max((n - 1) * (n - 2), 1)
    return {"betweennessVector": bc.tolist(), "normalized": (bc / denom).tolist()}


def _betweenness_device(adjacency: Matrix, sources, scale: float, chunk: int) -> np.ndarray:
    n = adjacency.shape[0]
    g = _unit_graph(adjacency)
    gT = g.transpose()
    t_in = in_edge_tables(g)      # in-edges: predecessors
    t_out = in_edge_tables(gT)    # in-edges of transpose = successors
    in_mask = t_in.costs < INF * 0.5
    out_mask = t_out.costs < INF * 0.5
    bc = np.zeros(n)
    for c0 in range(0, len(sources), chunk):
        cs = np.asarray(sources[c0 : c0 + chunk])
        # dist stays on the device between the BFS and Brandes phases; the
        # deepest level and the (n,) dependency sum are the chunk's reads
        dist = batched_distances_device(g, cs, unit_weights=True)
        L = int(torch.max(torch.where(dist < INF * 0.5, dist, -1.0)))
        if L <= 0:
            continue
        delta = _brandes_chunk(t_in.srcs, in_mask, t_out.srcs, out_mask, dist, L)
        bc += delta.cpu().double().numpy()[:n] * scale
    return bc


def _betweenness_host(adjacency: Matrix, sources, scale: float) -> np.ndarray:
    """Exact sequential Brandes (oracle; reference intent graph.ts:187-205)."""
    n = adjacency.shape[0]
    csr = adjacency.csr
    indptr, indices = csr.indptr, csr.indices
    bc = np.zeros(n)
    for s in sources:
        dist = np.full(n, -1, dtype=np.int64)
        sigma = np.zeros(n)
        dist[s] = 0
        sigma[s] = 1.0
        order = [int(s)]
        head = 0
        preds: list[list[int]] = [[] for _ in range(n)]
        while head < len(order):
            u = order[head]
            head += 1
            for idx in range(indptr[u], indptr[u + 1]):
                w = int(indices[idx])
                if w == u:
                    continue
                if dist[w] < 0:
                    dist[w] = dist[u] + 1
                    order.append(w)
                if dist[w] == dist[u] + 1:
                    sigma[w] += sigma[u]
                    preds[w].append(u)
        delta = np.zeros(n)
        for w in reversed(order):
            for u in preds[w]:
                delta[u] += sigma[u] / sigma[w] * (1.0 + delta[w])
            if w != s:
                bc[w] += delta[w] * scale
    return bc


def compute_centralities(adjacency: Matrix, measures=("pagerank", "closeness")) -> dict:
    results: dict = {}
    if "pagerank" in measures:
        pr = pagerank(adjacency)
        results["pagerank"] = pr.to_dict()
    if "closeness" in measures:
        results["closeness"] = closeness_centrality(adjacency)
    if "betweenness" in measures:
        results["betweenness"] = betweenness_centrality(adjacency)
    return results
