"""Network-flow workloads as diagonally-dominant solves, as in
``sublinear_tpu/graph/flow.py``.

Reference: scripts/network_flow/sublinear_flow.py, its
``electrical_network_analysis`` (:394, weighted Laplacian with
penalty-conductance voltage sources), ``maximum_flow_sublinear`` (:258) and
``minimum_cost_flow_sublinear`` (:326, conservation system).

The electrical formulation is the DD path (Laplacian CG solves on the
device, ``cg_step`` on the ``"csr"`` route); max-flow is the exact host
Edmonds-Karp oracle.  These functions take node counts and edge lists, not
a Matrix: their matrices take ``Matrix``'s default device (the card unless
the CPU is asked for).

``electrical_network`` and ``min_cost_flow`` ask CG for epsilon 1e-8, below
the f32 floor (~2e-7) of a true relative residual.  As in the JAX package,
``converged`` compares CG's recurrence residual with that threshold: the
recurrence can reach it while the true residual stays at the f32 level, or
the solve stops at ``max_iterations`` with ``converged=False``.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Sequence, Tuple

import numpy as np

from ..matrix import Matrix
from ..solvers.dispatch import solve
from ..types import SolverOptions


def weighted_laplacian(n: int, edges: Sequence[Tuple[int, int]], conductances) -> Matrix:
    """L = G^T C G for an undirected edge list."""
    conductances = np.asarray(conductances, dtype=np.float64)
    u = np.asarray([e[0] for e in edges], dtype=np.int64)
    v = np.asarray([e[1] for e in edges], dtype=np.int64)
    rows = np.concatenate([u, v, u, v])
    cols = np.concatenate([v, u, u, v])
    vals = np.concatenate([-conductances, -conductances, conductances, conductances])
    return Matrix.from_coo(rows, cols, vals, (n, n))


def electrical_network(
    n: int,
    edges: Sequence[Tuple[int, int]],
    resistances,
    voltage_sources: Dict[int, float],
    epsilon: float = 1e-8,
) -> dict:
    """Node voltages and edge currents (sublinear_flow.py:394-470 semantics:
    voltage sources become a large conductance to ground + current injection)."""
    resistances = np.asarray(resistances, dtype=np.float64)
    conduct = np.where(resistances > 0, 1.0 / np.where(resistances > 0, resistances, 1.0), 1.0)
    L = weighted_laplacian(n, edges, conduct)

    big = 1e6
    r, c, v = L.csr.to_coo()
    src_nodes = np.asarray(list(voltage_sources.keys()), dtype=np.int64)
    r = np.concatenate([r, src_nodes])
    c = np.concatenate([c, src_nodes])
    v = np.concatenate([v, np.full(src_nodes.size, big)])
    A = Matrix.from_coo(r, c, v, (n, n))

    current = np.zeros(n)
    for node, volt in voltage_sources.items():
        current[int(node)] = volt * big

    result = solve(A, current, SolverOptions(epsilon=epsilon, max_iterations=5000),
                   method="conjugate-gradient", raise_on_fail=False)
    voltages = result.solution
    edge_currents = [
        {"edge": (int(u), int(w)), "current": float((voltages[u] - voltages[w]) * g)}
        for (u, w), g in zip(edges, conduct)
    ]
    total_power = float(sum(((voltages[u] - voltages[w]) ** 2) * g for (u, w), g in zip(edges, conduct)))
    return {
        "voltages": voltages.tolist(),
        "edgeCurrents": edge_currents,
        "totalPowerDissipation": total_power,
        "convergenceInfo": {
            "iterations": result.iterations,
            "residual": result.residual,
            "converged": result.converged,
        },
    }


def max_flow(
    n: int,
    edges: Sequence[Tuple[int, int]],
    capacities,
    source: int,
    sink: int,
) -> dict:
    """Exact max flow (Edmonds-Karp, host-side) — the correctness oracle the
    reference benchmarks its linear-system relaxation against."""
    cap = {}
    adj: list[list[int]] = [[] for _ in range(n)]
    for (u, v), c in zip(edges, np.asarray(capacities, dtype=np.float64)):
        u, v = int(u), int(v)
        if (u, v) not in cap:
            adj[u].append(v)
            adj[v].append(u)
        cap[(u, v)] = cap.get((u, v), 0.0) + float(c)
        cap.setdefault((v, u), 0.0)

    flow = 0.0
    while True:
        parent = {source: source}
        q = deque([source])
        while q and sink not in parent:
            u = q.popleft()
            for v in adj[u]:
                if v not in parent and cap[(u, v)] > 1e-12:
                    parent[v] = u
                    q.append(v)
        if sink not in parent:
            break
        # bottleneck
        bott = float("inf")
        v = sink
        while v != source:
            u = parent[v]
            bott = min(bott, cap[(u, v)])
            v = u
        v = sink
        while v != source:
            u = parent[v]
            cap[(u, v)] -= bott
            cap[(v, u)] += bott
            v = u
        flow += bott
    return {"maxFlow": flow, "source": source, "sink": sink}


def min_cost_flow(
    n: int,
    edges: Sequence[Tuple[int, int]],
    costs,
    demands: Dict[int, float],
    epsilon: float = 1e-8,
) -> dict:
    """Quadratic-cost flow via the electrical formulation: solve L p = d with
    edge conductance 1/cost, flows f = C G p.  (The DD-solve path the
    reference's conservation system reduces to; sublinear_flow.py:326-390.)"""
    costs = np.asarray(costs, dtype=np.float64)
    conduct = np.where(costs > 0, 1.0 / np.where(costs > 0, costs, 1.0), 1.0)
    L = weighted_laplacian(n, edges, conduct)
    # ground node 0 to fix the potential gauge
    A = Matrix(L.csr.add_diagonal(0.0))
    r, c, v = A.csr.to_coo()
    r = np.concatenate([r, [0]])
    c = np.concatenate([c, [0]])
    v = np.concatenate([v, [1.0]])
    A = Matrix.from_coo(r, c, v, (n, n))

    d = np.zeros(n)
    for node, demand in demands.items():
        d[int(node)] = demand
    if abs(d.sum()) > 1e-9:
        raise ValueError("demands must balance (sum to zero)")

    result = solve(A, d, SolverOptions(epsilon=epsilon, max_iterations=5000),
                   method="conjugate-gradient", raise_on_fail=False)
    p = result.solution
    flows = [
        {"edge": (int(u), int(w)), "flow": float((p[u] - p[w]) * g)}
        for (u, w), g in zip(edges, conduct)
    ]
    total_cost = float(sum(f["flow"] ** 2 * cst for f, cst in zip(flows, costs)))
    return {
        "flows": flows,
        "totalCost": total_cost,
        "potentials": p.tolist(),
        "convergenceInfo": {
            "iterations": result.iterations,
            "residual": result.residual,
            "converged": result.converged,
        },
    }
