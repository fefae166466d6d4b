"""The port's BMSSP (bulk Bellman-Ford shortest paths) and hybrid solvers
against the JAX package's.

Tolerances: the in-edge tables are bit-identical to the reference's arrays
(on the first n rows); ``shortest_paths`` and ``batched_distances`` match
the reference within rtol 1e-6 with the same sweep count (both relax the
same f32 sums with the first minimum winning), and match a host Dijkstra
oracle within rtol 1e-5 on the reached nodes; BMSSP's small-n and dense
fallbacks give the reference's method strings; hybrid's phases (names,
switch reasons, iterations) equal the reference's and its solution agrees
within rtol 5e-4 (absolute 1e-4), the JAX tests' tolerance against the f64
oracle.  The hybrid case whose push phase stalls runs the walker phase,
where the streams differ: there both residuals must fall under the RHS
norm and the phases' names and order must match.
"""
import heapq

import numpy as np
import pytest
import torch

import sublinear_tpu as slt
import sublinear_tpu_torch as slp
from sublinear_tpu.errors import SolverError as JaxSolverError
from sublinear_tpu.solvers import bmssp as JB
from sublinear_tpu.solvers.hybrid import solve_hybrid as jax_hybrid
from sublinear_tpu_torch.errors import SolverError as PortSolverError
from sublinear_tpu_torch.solvers import bmssp as B
from sublinear_tpu_torch.solvers.hybrid import solve_hybrid as port_hybrid

from torch_parity import dd_coo, matrix_pair, port_on_cpu

torch.set_num_threads(2)


def dijkstra(csr, sources, bound=np.inf):
    """Multi-source Dijkstra over A's graph (edge i -> j of cost 1/|a_ij|,
    i != j), with heapq, in f64."""
    n = csr.shape[0]
    dist = np.full(n, np.inf)
    heap = []
    for s in sources:
        dist[s] = 0.0
        heap.append((0.0, int(s)))
    heapq.heapify(heap)
    while heap:
        d, u = heapq.heappop(heap)
        if d > dist[u]:
            continue
        for k in range(csr.indptr[u], csr.indptr[u + 1]):
            v = int(csr.indices[k])
            if v == u:
                continue
            nd = d + 1.0 / max(abs(csr.data[k]), 1e-30)
            if nd < dist[v] and nd <= bound:
                dist[v] = nd
                heapq.heappush(heap, (nd, v))
    return dist


def _graph(n=512, seed=9, density=0.004):
    a = slt.generate("random-sparse", n, seed=seed, density=density)
    p = slp.generate("random-sparse", n, seed=seed, density=density)
    return a, p


@pytest.mark.parametrize("prefer", [None, "xbar"])
def test_in_edge_tables_bit_identical(prefer):
    n = 600
    a, p = matrix_pair(*dd_coo(n, deg=5, seed=81), (n, n), prefer=prefer)
    tj, tp = JB.in_edge_tables(a), B.in_edge_tables(p)
    for name in ("srcs", "costs"):
        want = np.asarray(getattr(tj, name))[:n]
        got = getattr(tp, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert B.in_edge_tables(p) is tp


@pytest.mark.parametrize("sources,bound", [([0], B.INF), ([3, 77, 400], B.INF),
                                           ([5, 9], 6.0)])
def test_shortest_paths_match(sources, bound):
    a, p = _graph()
    vals = np.arange(1.0, len(sources) + 1.0)
    dj, xj, sj = JB.shortest_paths(a, sources, vals, bound=bound)
    dp, xp, sp = B.shortest_paths(p, sources, vals, bound=bound)
    n = p.shape[0]
    assert sp == sj
    np.testing.assert_allclose(dp, dj[:n], rtol=1e-6)
    np.testing.assert_allclose(xp, xj[:n], rtol=1e-6)
    ref = dijkstra(p.csr, sources, bound)
    reach = np.isfinite(ref)
    np.testing.assert_allclose(dp[reach], ref[reach], rtol=1e-5)
    assert np.all(dp[~reach] > 1e29)


@pytest.mark.parametrize("unit", [False, True])
def test_batched_distances_match(unit):
    a, p = _graph(n=400, seed=10, density=0.01)
    sources = np.array([0, 5, 17, 200, 399])
    want = JB.batched_distances(a, sources, unit_weights=unit, chunk=2)
    got = B.batched_distances(p, sources, unit_weights=unit, chunk=2)
    assert got.shape == (5, 400) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if not unit:
        for row, s in zip(got, sources):
            ref = dijkstra(p.csr, [s])
            reach = np.isfinite(ref)
            np.testing.assert_allclose(row[reach], ref[reach], rtol=1e-5)


def test_batched_distances_device_is_n_by_s():
    _, p = _graph(n=300, seed=11, density=0.01)
    dist = B.batched_distances_device(p, [1, 2, 3])
    assert dist.shape == (300, 3) and dist.device.type == "cpu"
    assert dist[1, 0] == 0.0 and dist[3, 2] == 0.0


BMSSP_CASES = {
    # n < 100: CG
    "small": (lambda pkg: pkg.generate("random-sparse", 64, seed=8,
                                       density=0.1), lambda n: pkg_rhs(n)),
    # a sparse RHS on a sparse graph: the Bellman-Ford path
    "graph": (lambda pkg: pkg.generate("random-sparse", 512, seed=9,
                                       density=0.004), lambda n: _e(n, [3])),
    # a dense RHS reaching most nodes: the BiCGSTAB fallback
    "fallback": (lambda pkg: pkg.generate("random-sparse", 1000, seed=7,
                                          density=1e-3), lambda n: pkg_rhs(n)),
}


def pkg_rhs(n):
    return slt.rhs(n, seed=n)


def _e(n, idx):
    b = np.zeros(n)
    b[idx] = 1.0
    return b


@pytest.mark.parametrize("case", sorted(BMSSP_CASES))
def test_bmssp_method_strings_match(case):
    make, rhs = BMSSP_CASES[case]
    a, p = make(slt), make(slp)
    b = rhs(a.shape[0])
    rj = slt.solve(a, b, method="bmssp", epsilon=1e-6, raise_on_fail=False)
    rp = slp.solve(p, b, method="bmssp", epsilon=1e-6, raise_on_fail=False)
    assert rp.method == rj.method
    assert rp.method == {"small": "bmssp(cg)", "graph": "bmssp",
                         "fallback": "bmssp(cg-fallback)"}[case]
    assert rp.converged == rj.converged
    if case == "graph":
        assert rp.iterations == rj.iterations
        np.testing.assert_allclose(rp.solution, rj.solution, rtol=1e-6)
        assert abs(rp.solution[3] - 1.0) < 1e-6
    else:
        np.testing.assert_allclose(rp.solution, rj.solution, rtol=0,
                                   atol=1e-5 * np.abs(rj.solution).max())


def test_bmssp_zero_rhs():
    _, p = _graph()
    r = slp.solve(p, np.zeros(512), method="bmssp")
    assert r.method == "bmssp" and r.converged and not r.solution.any()


def test_hybrid_matches_reference():
    a, p = _graph(n=96, seed=7, density=0.06)
    b = slt.rhs(96, seed=7)
    rj = slt.solve(a, b, method="hybrid", epsilon=1e-6)
    rp = slp.solve(p, b, method="hybrid", epsilon=1e-6)
    assert rj.converged and rp.converged and rp.method == rj.method == "hybrid"
    assert rp.iterations == rj.iterations
    assert ([(q["phase"], q.get("switch_reason"), q["iterations"])
             for q in rp.phases]
            == [(q["phase"], q.get("switch_reason"), q["iterations"])
                for q in rj.phases])
    np.testing.assert_allclose(rp.solution, rj.solution, rtol=5e-4, atol=1e-4)


def test_hybrid_rate_switching_matches():
    """The weakly dominant tridiagonal system of the JAX tests: the push
    phase stalls and the improvement-rate rule switches it, in both."""
    n = 200
    a = slt.generate("tridiagonal", n, off_diagonal=-0.49)
    p = slp.generate("tridiagonal", n, off_diagonal=-0.49)
    b = slt.rhs(n, seed=2)
    rj = slt.solve(a, b, slt.SolverOptions(method="hybrid", epsilon=1e-6))
    rp = slp.solve(p, b, slp.SolverOptions(method="hybrid", epsilon=1e-6))
    assert rj.converged and rp.converged
    assert rp.phases[0]["switch_reason"] == rj.phases[0]["switch_reason"]
    assert rp.phases[0]["iterations"] == rj.phases[0]["iterations"]
    np.testing.assert_allclose(rp.phases[0]["history"], rj.phases[0]["history"],
                               rtol=5e-4)
    np.testing.assert_allclose(rp.solution, rj.solution, rtol=5e-4, atol=1e-4)


def test_hybrid_walker_phase_runs(monkeypatch):
    """The JAX tests' forcing case at a small n: a tiny iteration budget
    ends the push phase with a large residual, so the walker phase runs (its
    walkers chunked by a 2 MB budget), with a decaying blend."""
    monkeypatch.setenv("SLT_MEMORY_LIMIT_BYTES", str(2_000_000))
    n = 2000
    a = slt.Matrix(slt.generate("tridiagonal", n).csr.add_diagonal(0.5))
    p = slp.Matrix(slp.generate("tridiagonal", n).csr.add_diagonal(0.5))
    b = slt.rhs(n, seed=3)
    kw = dict(epsilon=1e-6, max_iterations=20, max_walk_length=64)
    rj = jax_hybrid(a, b, slt.SolverOptions(**kw), raise_on_fail=False)
    rp = port_hybrid(p, b, slp.SolverOptions(**kw), raise_on_fail=False)
    assert [q["phase"] for q in rp.phases] == [q["phase"] for q in rj.phases]
    assert "random-walk" in [q["phase"] for q in rp.phases]
    mc = [q for q in rp.phases if q["phase"] == "random-walk"][0]
    assert all(b2 < b1 for b1, b2 in zip(mc["blends"], mc["blends"][1:]))
    assert np.all(np.isfinite(rp.solution))
    assert rp.residual < float(np.linalg.norm(b))


def _non_dd(pkg):
    return pkg.Matrix.from_dense(
        np.array([[1.0, 2.0, 0.0], [0.5, 1.0, 3.0], [0.0, 1.0, 1.0]]))


def test_hybrid_non_dd_raises_e001():
    with pytest.raises(JaxSolverError) as jexc:
        slt.solve(_non_dd(slt), np.ones(3), method="hybrid")
    with pytest.raises(PortSolverError) as pexc:
        slp.solve(_non_dd(slp), np.ones(3), method="hybrid")
    assert jexc.value.code == pexc.value.code == "E001"
