"""BMSSP, the bounded multi-source shortest-path approximate solver, as in
``sublinear_tpu/solvers/bmssp.py``.

The matrix is a graph with edge cost 1/|a_ij|; a multi-source bounded
shortest-path search from the nonzero RHS entries sets
x_i = b_src / (1 + dist_i).  Small or dense systems go to CG, and a search
that reaches more than half the nodes falls back to BiCGSTAB, as in the
JAX package.

The search is bulk Bellman-Ford: every sweep relaxes all in-edges at once,

    dist_j = min(dist_j, min_k dist[src_k(j)] + cost_k(j))    (bounded)

a gather of dist over the (n, K) in-edge table, the sum with the costs and
the row argmin (the first minimum wins, as ``jnp.argmin``), with the source
value carried along.  The JAX package loops on the device while a sweep
improves something, up to ``MAX_SWEEPS``; here a host loop enqueues blocks
of ``SWEEP_BLOCK`` sweeps, an on-device ``changed`` flag freezes the state
and the sweep count once a sweep improved nothing, and the host reads the
flag once per block.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_dtype, to_device
from ..matrix import Matrix
from ..types import SolverOptions, SolverResult
from ..utils.lru import LRUCache
from . import base, cg as _cg

INF = 1e30
MAX_SWEEPS = 128   # diameter cap; random sparse graphs have tiny diameters
SWEEP_BLOCK = 8    # sweeps enqueued per read of the changed flag


class InEdgeTables:
    def __init__(self, srcs, costs, n_pad):
        self.srcs = srcs    # (n_pad, K) int32: source node of each in-edge
        self.costs = costs  # (n_pad, K): 1/|a_ij|, INF padding
        self.n_pad = n_pad


_TABLE_CACHE = LRUCache(maxsize=32)


def in_edge_tables(matrix: Matrix, dtype=None) -> InEdgeTables:
    """The in-edge tables of ``matrix`` (built with NumPy as the JAX package
    builds them, then moved to the device), cached per (matrix, dtype)."""
    dt = resolve_dtype(dtype)
    key = (matrix.uid, str(dt))
    hit = _TABLE_CACHE.get(key)
    if hit is not None:
        return hit
    csc = matrix.T_csr()  # rows of A^T = in-edges of A's graph
    n = csc.shape[0]
    n_pad = matrix.op(dt).n_pad

    rows = csc.row_of_entry()  # target node j
    off = csc.indices != rows
    t_rows, t_srcs, t_vals = rows[off], csc.indices[off], csc.data[off]

    cnt = np.zeros(n, dtype=np.int64)
    np.add.at(cnt, t_rows, 1)
    K = max(int(cnt.max()) if cnt.size else 1, 1)
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(cnt, out=starts[1:])
    pos = np.arange(t_rows.size) - starts[t_rows]

    srcs = np.zeros((n_pad, K), dtype=np.int32)
    costs = np.full((n_pad, K), INF)
    srcs[t_rows, pos] = t_srcs
    with np.errstate(divide="ignore"):
        costs[t_rows, pos] = 1.0 / np.maximum(np.abs(t_vals), 1e-30)

    tables = InEdgeTables(to_device(srcs, torch.int32, matrix.device),
                          to_device(costs, dt, matrix.device), n_pad)
    _TABLE_CACHE.put(key, tables)
    return tables


def _sweeps(relax, state, flag):
    """Run ``relax(state) -> (state, improved_any)`` while a sweep improves
    something, at most MAX_SWEEPS times, in blocks of SWEEP_BLOCK with one
    host read per block.  ``flag`` is the carried on-device bool; returns
    (state, sweeps)."""
    sweeps = torch.zeros((), dtype=torch.int64, device=flag.device)
    done = 0
    while done < MAX_SWEEPS:
        end = min(done + SWEEP_BLOCK, MAX_SWEEPS)
        for _ in range(done, end):
            new_state, improved = relax(state)
            state = tuple(torch.where(flag, new, old)
                          for new, old in zip(new_state, state))
            sweeps = sweeps + flag
            flag = flag & improved
        done = end
        if not bool(flag):  # the one device-to-host read per block
            break
    return state, int(sweeps)


def _bmssp_run(srcs, costs, dist0, srcval0, bound):
    """Bounded multi-source Bellman-Ford with the source value carried:
    returns (x, dist, visited, sweeps)."""
    K = srcs.shape[1]
    row_base = torch.arange(srcs.shape[0], device=srcs.device) * K
    src_flat = srcs.reshape(-1).long()

    def relax(state):
        dist, srcval = state
        cand = dist[src_flat].view(-1, K) + costs         # (n_pad, K)
        best, k_best = torch.min(cand, dim=1)
        improved = (best < dist) & (best <= bound)
        sv_best = srcval[src_flat[row_base + k_best]]
        return ((torch.where(improved, best, dist),
                 torch.where(improved, sv_best, srcval)),
                torch.any(improved))

    flag = torch.ones((), dtype=torch.bool, device=dist0.device)
    (dist, srcval), sweeps = _sweeps(relax, (dist0, srcval0), flag)
    reached = dist < INF * 0.5
    visited = reached.sum()
    x = torch.where(reached, srcval / (1.0 + dist), 0.0)
    return x, dist, visited, sweeps


def shortest_paths(matrix: Matrix, sources, source_values=None,
                   bound: float = INF, dtype=None):
    """Bounded multi-source shortest paths over the matrix graph (edge cost
    1/|a_ij|).  Returns (dist, carried_source_value, sweeps)."""
    tables = in_edge_tables(matrix, dtype)
    dt = resolve_dtype(dtype)
    n_pad = tables.n_pad
    dist0 = np.full(n_pad, INF)
    srcval0 = np.zeros(n_pad)
    sources = np.asarray(sources, dtype=np.int64).reshape(-1)
    vals = (np.asarray(source_values, dtype=np.float64).reshape(-1)
            if source_values is not None else np.ones(sources.size))
    dist0[sources] = 0.0
    srcval0[sources] = vals
    dev = matrix.device
    bound_t = torch.tensor(bound, dtype=dt, device=dev)
    x, dist, _, sweeps = _bmssp_run(
        tables.srcs, tables.costs, to_device(dist0, dt, dev),
        to_device(srcval0, dt, dev), bound_t)
    return (dist.cpu().double().numpy(), x.cpu().double().numpy(), sweeps)


# ---------------------------------------------------------------- batched

def _dist_batch_run(srcs, costs, dist0):
    """Batched multi-source Bellman-Ford: dist0 (n_pad, S) -> relaxed
    distances and sweeps.  The batch axis is minor, so each gather pulls a
    contiguous row of S distances."""
    src_flat = srcs.reshape(-1).long()
    n_pad, K = srcs.shape

    def relax(state):
        (dist,) = state
        gathered = dist[src_flat].view(n_pad, K, -1)       # (n_pad, K, S)
        cand = torch.amin(gathered + costs[:, :, None], dim=1)
        improved = cand < dist
        return (torch.where(improved, cand, dist),), torch.any(improved)

    flag = torch.ones((), dtype=torch.bool, device=dist0.device)
    (dist,), sweeps = _sweeps(relax, (dist0,), flag)
    return dist, sweeps


def _unit_costs(tables, unit_weights: bool):
    costs = tables.costs
    if unit_weights:
        costs = torch.where(costs < INF * 0.5, 1.0, costs)
    return costs


def batched_distances_device(matrix: Matrix, sources_chunk,
                             unit_weights: bool = False, dtype=None):
    """Single-chunk distances kept on the device: (n_pad, S), built from S
    uploaded source ints."""
    tables = in_edge_tables(matrix, dtype)
    costs = _unit_costs(tables, unit_weights)
    cs = to_device(np.asarray(sources_chunk, dtype=np.int64), torch.int64,
                   matrix.device)
    S = cs.numel()
    dist0 = torch.full((tables.n_pad, S), INF, dtype=costs.dtype,
                       device=costs.device)
    dist0[cs, torch.arange(S, device=costs.device)] = 0.0
    dist, _ = _dist_batch_run(tables.srcs, costs, dist0)
    return dist


def batched_distances(matrix: Matrix, sources, unit_weights: bool = False,
                      dtype=None, chunk: int = 64):
    """Distances from many sources in chunked sweeps.  Returns (S, n)
    float64.  unit_weights=True treats every edge as cost 1 (BFS levels)
    regardless of values."""
    sources = np.asarray(sources, dtype=np.int64).reshape(-1)
    n = matrix.shape[0]
    out = np.empty((sources.size, n), dtype=np.float64)
    for c0 in range(0, sources.size, chunk):
        cs = sources[c0: c0 + chunk]
        dist = batched_distances_device(matrix, cs, unit_weights, dtype)
        out[c0: c0 + len(cs)] = dist[:n].cpu().double().numpy().T
    return out


def solve_bmssp(matrix: Matrix, b, options: SolverOptions,
                raise_on_fail: bool = True) -> SolverResult:
    n = matrix.shape[0]
    b = np.asarray(b, dtype=np.float64).reshape(-1)
    threshold = base.threshold_for(b, options)

    # auto-select CG for small or dense systems
    if n < 100 or matrix.density > 0.1:
        r = _cg.solve_cg(matrix, b, options, raise_on_fail=False)
        if not r.converged:
            r = _cg.solve_bicgstab(matrix, b, options,
                                   raise_on_fail=raise_on_fail)
        r.method = "bmssp(cg)"
        return r

    sources = np.nonzero(np.abs(b) > 1e-12)[0]
    if sources.size == 0:
        return SolverResult(np.zeros(n), 0, 0.0, True, "bmssp")

    with base.SolveTimer(matrix.device) as t:
        dist, x, sweeps = shortest_paths(matrix, sources, b[sources],
                                         dtype=options.dtype)
    visited = int(np.sum(dist[:n] < INF * 0.5))
    if visited > n // 2 and sources.size > n // 100:
        # dense reach: the graph heuristic explores everything; CG is better
        r = _cg.solve_bicgstab(matrix, b, options, raise_on_fail=raise_on_fail)
        r.method = "bmssp(cg-fallback)"
        return r

    x = x[:n]
    res = float(np.linalg.norm(matrix.csr.matvec(x) - b))
    return SolverResult(
        solution=x,
        iterations=sweeps,
        residual=res,
        converged=res <= threshold,
        method="bmssp",
        compute_time_ms=t.ms,
    )
