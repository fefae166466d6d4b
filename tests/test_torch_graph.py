"""The port's graph layer against the JAX package's, on the CPU.

Tolerances: PageRank scores within 1e-6 absolute, iterations within one
check block (5) and equal ``converged`` (f32 sums taken in another order);
the CG-based measures (effective resistance, the flows) within 1e-4 of the
largest entry, the Friedkin-Johnsen opinions within 1e-5, with equal
``converged``; betweenness within rtol 1e-5 of the exact host Brandes.
Host code is held bit for bit: the transition and Laplacian matrices,
Edmonds-Karp, label propagation, modularity, community detection and
closeness (integer BFS levels on both sides).
"""
import numpy as np
import pytest
import torch

import sublinear_tpu as slt
import sublinear_tpu_torch as slp
from sublinear_tpu import graph as JG
from sublinear_tpu.graph import centrality as JC
from sublinear_tpu.errors import SolverError as JaxSolverError
from sublinear_tpu.graph import flow as JF
from sublinear_tpu_torch import graph as G
from sublinear_tpu_torch.errors import SolverError as PortSolverError
from sublinear_tpu_torch.graph import centrality as C
from sublinear_tpu_torch.graph import flow as F
from sublinear_tpu_torch.graph.pagerank import (
    CHECK_EVERY, PageRankResult, _transition_matrix, pagerank_inputs)

from torch_parity import port_on_cpu

torch.set_num_threads(2)


def _pair_coo(rows, cols, vals, n):
    return (slt.Matrix.from_coo(rows, cols, vals, (n, n)),
            slp.Matrix.from_coo(rows, cols, vals, (n, n)))


def random_digraph(n, p=0.1, seed=0):
    """tests/test_graph.py's dense random digraph, in both packages."""
    rng = np.random.default_rng(seed)
    dense = (rng.random((n, n)) < p).astype(float)
    np.fill_diagonal(dense, 0.0)
    return slt.Matrix.from_dense(dense), slp.Matrix.from_dense(dense)


def sparse_digraph(n=5000, out=5, seed=1):
    """``out`` uniform out-edges per node, self-loops dropped: large and
    sparse enough for the port's "csr" route."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(n), out)
    c = rng.integers(0, n, out * n)
    keep = r != c
    return _pair_coo(r[keep], c[keep], np.ones(int(keep.sum())), n)


def ring_graph(n=32):
    i = np.arange(n)
    return _pair_coo(np.r_[i, i], np.r_[(i + 1) % n, (i - 1) % n],
                     np.ones(2 * n), n)


def connected_graph(n=200, extra=600, seed=7):
    """The ring (i, i+1 mod n) plus ``extra`` uniform random edges: the
    edge list of a connected undirected graph."""
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    u = np.r_[i, rng.integers(0, n, extra)]
    v = np.r_[(i + 1) % n, rng.integers(0, n, extra)]
    return list(zip(u.tolist(), v.tolist()))


GRAPHS = {
    "digraph60": lambda: random_digraph(60, 0.12, seed=1),
    "sparse5000": sparse_digraph,
    "ring32": ring_graph,
}


def _same_pagerank(want, got):
    np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=1e-6)
    assert abs(got.iterations - want.iterations) <= CHECK_EVERY
    assert got.converged == want.converged
    assert got.damping == want.damping
    assert got.personalized == want.personalized
    assert abs(got.scores.sum() - 1.0) < 1e-5


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_pagerank_matches(graph):
    a, p = GRAPHS[graph]()
    _same_pagerank(JG.pagerank(a), G.pagerank(p))


def test_pagerank_routes_and_ring():
    _, p = sparse_digraph()
    opT, v, dangling = pagerank_inputs(p)
    assert type(opT).__name__ == "CsrOperator" and opT.shape == (5000, 5000)
    assert v.shape == dangling.shape == (5000,) and dangling.dtype == torch.bool
    _, ring = ring_graph(32)
    np.testing.assert_allclose(G.pagerank(ring).scores, np.full(32, 1 / 32),
                               atol=1e-6)


def test_transition_matrix_bit_identical():
    a, p = sparse_digraph(n=600, seed=4)
    from sublinear_tpu.graph.pagerank import _transition_matrix as jtm

    ja, pa = jtm(a).csr, _transition_matrix(p).csr
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(ja, name), getattr(pa, name))


@pytest.mark.parametrize("graph,nodes", [("digraph60", [3]),
                                         ("sparse5000", [3, 17, 400, 4999])])
def test_personalized_pagerank_matches(graph, nodes):
    a, p = GRAPHS[graph]()
    _same_pagerank(JG.personalized_pagerank(a, nodes, epsilon=1e-8),
                   G.personalized_pagerank(p, nodes, epsilon=1e-8))


def test_pagerank_errors_match():
    a, p = random_digraph(20, 0.2, seed=3)
    for call in (lambda pkg, m: pkg.pagerank(m, damping=1.5),
                 lambda pkg, m: pkg.personalized_pagerank(m, [20])):
        with pytest.raises(JaxSolverError) as jexc:
            call(JG, a)
        with pytest.raises(PortSolverError) as pexc:
            call(G, p)
        assert jexc.value.code == pexc.value.code
        assert type(jexc.value).__name__ == type(pexc.value).__name__


def test_pagerank_statistics_bit_identical():
    a, _ = random_digraph(40, 0.15, seed=5)
    r = JG.pagerank(a)
    carried = PageRankResult(scores=r.scores.copy(), iterations=r.iterations,
                             residual=r.residual, converged=r.converged,
                             damping=r.damping)
    assert G.pagerank_statistics(carried) == JG.pagerank_statistics(r)
    assert carried.to_dict() == r.to_dict()


def test_pagerank_reads_once_per_block(monkeypatch):
    """Each 5-step block is 5 products plus the residual check's one, after
    the initial residual: 1 + 6 k / 5 products for k steps."""
    _, p = sparse_digraph()
    opT, v, dangling = pagerank_inputs(p)
    calls = {"matvec": 0}
    plain = type(opT).matvec

    def counting(self, x):
        calls["matvec"] += 1
        return plain(self, x)

    monkeypatch.setattr(type(opT), "matvec", counting)
    from sublinear_tpu_torch.graph.pagerank import pagerank_run

    _, k, res = pagerank_run(opT, v, dangling, 0.85, 1e-6, 1000)
    assert k % CHECK_EVERY == 0 and k > 0 and res <= 1e-6
    assert calls["matvec"] == 1 + (CHECK_EVERY + 1) * k // CHECK_EVERY


def _count_builds(monkeypatch):
    """Count the calls of ``_transition_matrix``: P^T's builds."""
    import importlib

    # the package exports the function ``pagerank`` under the module's name
    P = importlib.import_module("sublinear_tpu_torch.graph.pagerank")
    builds = []
    plain = P._transition_matrix

    def counting(*args, **kwargs):
        builds.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(P, "_transition_matrix", counting)
    return builds


PAGERANK_CALLS = {
    "pagerank": lambda m: G.pagerank(m),
    "personalized": lambda m: G.personalized_pagerank(m, [3], epsilon=1e-8),
    "personalized_again": lambda m: G.personalized_pagerank(m, [7, 20]),
}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_pagerank_on_a_kept_graph_is_bit_equal_to_a_fresh_one(graph,
                                                              monkeypatch):
    """Calls on one Matrix (P^T built by the first, then found) answer bit
    for bit as the same calls on a fresh Matrix of the same COO each."""
    builds = _count_builds(monkeypatch)
    _, kept = GRAPHS[graph]()
    for name, call in PAGERANK_CALLS.items():
        got = call(kept)
        want = call(GRAPHS[graph]()[1])
        np.testing.assert_array_equal(got.scores, want.scores, err_msg=name)
        assert (got.iterations, got.residual) == (want.iterations,
                                                  want.residual)
    # one build on the kept graph, one on each fresh graph
    assert len(builds) == 1 + len(PAGERANK_CALLS)


def test_pagerank_builds_once_per_dtype(monkeypatch):
    builds = _count_builds(monkeypatch)
    _, p = random_digraph(60, 0.12, seed=1)  # the dense route keeps dtype
    f32 = pagerank_inputs(p, [1.0] * 60)
    assert pagerank_inputs(p, [1.0] * 60)[0] is f32[0]
    assert G.pagerank(p).scores.shape == (60,) and len(builds) == 1
    f64 = pagerank_inputs(p, None, torch.float64)
    assert len(builds) == 2 and f64[0] is not f32[0]
    assert f64[0].dtype == torch.float64 and f32[0].dtype == torch.float32
    assert pagerank_inputs(p, None, "float64")[0] is f64[0]
    assert pagerank_inputs(p)[2] is f32[2] and len(builds) == 2
    assert sorted(p._pagerank) == ["torch.float32", "torch.float64"]
    # the counters, under a profiler: a miss on a fresh graph, then a hit
    from torch.profiler import ProfilerActivity, profile
    from sublinear_tpu_torch import tracing

    tracing.reset()
    _, fresh = random_digraph(60, 0.12, seed=1)
    with profile(activities=[ProfilerActivity.CPU]):
        G.personalized_pagerank(fresh, [3])
        G.personalized_pagerank(fresh, [4])
    counts = tracing.counters()
    tracing.reset()
    assert counts["pagerank_transition_builds"] == 1
    assert counts["pagerank_transition_hits"] == 1


def test_pagerank_cache_dies_with_the_matrix_and_builds_once_across_threads(
        monkeypatch):
    import gc
    import sys
    import threading
    import weakref

    _, p = sparse_digraph(n=5000, seed=2)
    G.pagerank(p)
    opT = pagerank_inputs(p)[0]
    refs = weakref.ref(p), weakref.ref(opT)
    del p, opT
    gc.collect()
    assert refs[0]() is None and refs[1]() is None

    builds = _count_builds(monkeypatch)
    _, cold = sparse_digraph(n=5000, seed=2)
    threads = 8
    start = threading.Barrier(threads)
    got = [None] * threads

    def query(i):
        start.wait(timeout=60)
        got[i] = G.personalized_pagerank(cold, [11])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=query, args=(i,))
                   for i in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert len(builds) == 1 and len(cold._pagerank) == 1
    for r in got[1:]:
        np.testing.assert_array_equal(r.scores, got[0].scores)


# ------------------------------------------------------------ resistance

def test_grounded_laplacian_bit_identical():
    edges = connected_graph(50, 100)
    La = JF.weighted_laplacian(50, edges, np.ones(len(edges)))
    Lp = F.weighted_laplacian(50, edges, np.ones(len(edges)))
    for ja, pa in ((La.csr, Lp.csr),
                   (JG.grounded_laplacian(La).csr, G.grounded_laplacian(Lp).csr)):
        for name in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(ja, name), getattr(pa, name))


@pytest.mark.parametrize("n,pairs", [(3, [(0, 2), (0, 1), (1, 1)]),
                                     (200, [(0, 100), (5, 199), (199, 3)])])
def test_effective_resistance_matches(n, pairs):
    edges = ([(0, 1), (1, 2)] if n == 3 else connected_graph(n, 600))
    w = np.ones(len(edges))
    La = JF.weighted_laplacian(n, edges, w)
    Lp = F.weighted_laplacian(n, edges, w)
    pinv = np.linalg.pinv(Lp.to_dense())
    for s, t in pairs:
        want = JG.effective_resistance(La, s, t)
        got = G.effective_resistance(Lp, s, t)
        exact = pinv[s, s] + pinv[t, t] - 2 * pinv[s, t]
        assert abs(got["effectiveResistance"] - want["effectiveResistance"]) \
            <= 1e-4 * max(exact, 1.0)
        assert abs(got["effectiveResistance"] - exact) <= 1e-4 * max(exact, 1.0)
        np.testing.assert_allclose(got["voltage"], want["voltage"], rtol=0,
                                   atol=1e-4 * max(np.abs(want["voltage"]).max(), 1.0))
        if s != t:
            assert (got["convergenceInfo"]["converged"]
                    == want["convergenceInfo"]["converged"])


# ------------------------------------------------------------ flows

@pytest.mark.parametrize("n", [3, 150])
def test_electrical_network_matches(n):
    if n == 3:
        edges, res, src = [(0, 1), (1, 2)], [1.0, 1.0], {0: 1.0, 2: 0.0}
    else:
        edges = connected_graph(n, 400, seed=2)
        res = np.random.default_rng(2).uniform(0.5, 2.0, len(edges))
        src = {0: 1.0, n - 1: 0.0}
    want = JF.electrical_network(n, edges, res, src)
    got = F.electrical_network(n, edges, res, src)
    np.testing.assert_allclose(got["voltages"], want["voltages"], rtol=0,
                               atol=1e-4)
    gc = np.array([e["current"] for e in got["edgeCurrents"]])
    wc = np.array([e["current"] for e in want["edgeCurrents"]])
    np.testing.assert_allclose(gc, wc, rtol=0, atol=1e-4 * max(np.abs(wc).max(), 1))
    assert [e["edge"] for e in got["edgeCurrents"]] == \
        [e["edge"] for e in want["edgeCurrents"]]
    assert abs(got["totalPowerDissipation"] - want["totalPowerDissipation"]) \
        <= 1e-4 * max(want["totalPowerDissipation"], 1.0)
    assert (got["convergenceInfo"]["converged"]
            == want["convergenceInfo"]["converged"])


@pytest.mark.parametrize("n", [3, 150])
def test_min_cost_flow_matches(n):
    if n == 3:
        edges, costs, dem = [(0, 1), (1, 2), (0, 2)], [1.0, 1.0, 2.0], {0: 1.0, 2: -1.0}
    else:
        edges = connected_graph(n, 400, seed=3)
        costs = np.random.default_rng(3).uniform(0.5, 2.0, len(edges))
        dem = {0: 1.0, n // 2: -1.0}
    want = JF.min_cost_flow(n, edges, costs, dem)
    got = F.min_cost_flow(n, edges, costs, dem)
    np.testing.assert_allclose(got["potentials"], want["potentials"], rtol=0,
                               atol=1e-4 * max(np.abs(want["potentials"]).max(), 1))
    gf = np.array([f["flow"] for f in got["flows"]])
    wf = np.array([f["flow"] for f in want["flows"]])
    np.testing.assert_allclose(gf, wf, rtol=0, atol=1e-4)
    assert abs(got["totalCost"] - want["totalCost"]) <= 1e-4 * max(want["totalCost"], 1)
    assert (got["convergenceInfo"]["converged"]
            == want["convergenceInfo"]["converged"])
    with pytest.raises(ValueError):
        F.min_cost_flow(n, edges, costs, {0: 1.0})


def test_max_flow_bit_identical():
    rng = np.random.default_rng(9)
    n = 40
    edges = [(int(u), int(v)) for u, v in rng.integers(0, n, (200, 2)) if u != v]
    caps = rng.uniform(0.1, 3.0, len(edges))
    for s, t in ((0, n - 1), (3, 17)):
        assert F.max_flow(n, edges, caps, s, t) == JF.max_flow(n, edges, caps, s, t)
    assert F.max_flow(4, [(0, 1), (0, 2), (1, 3), (2, 3)], [3, 2, 2, 3], 0,
                      3)["maxFlow"] == 4.0


# ------------------------------------------------------------ social

def test_row_normalize_bit_identical():
    a, p = random_digraph(30, 0.2, seed=6)
    ja, pa = JG.social.row_normalize(a).csr, G.social.row_normalize(p).csr
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(ja, name), getattr(pa, name))


@pytest.mark.parametrize("graph", ["digraph60", "sparse5000"])
def test_opinion_dynamics_match(graph):
    a, p = GRAPHS[graph]()
    n = a.shape[0]
    x0 = np.random.default_rng(8).uniform(-1, 1, n)
    want = JG.friedkin_johnsen(a, x0, susceptibility=0.5)
    got = G.friedkin_johnsen(p, x0, susceptibility=0.5)
    np.testing.assert_allclose(got["opinions"], want["opinions"], rtol=0,
                               atol=1e-5)
    assert (got["convergenceInfo"]["converged"]
            == want["convergenceInfo"]["converged"])
    assert abs(got["convergenceInfo"]["iterations"]
               - want["convergenceInfo"]["iterations"]) <= CHECK_EVERY
    want = JG.degroot_consensus(a, x0, steps=30)
    got = G.degroot_consensus(p, x0, steps=30)
    np.testing.assert_allclose(got["opinions"], want["opinions"], rtol=0,
                               atol=1e-6)
    assert got["steps"] == want["steps"] == 30


def test_influence_propagation_matches():
    a, p = sparse_digraph()
    seeds = [0, 10, 2500]
    want = JG.influence_propagation(a, seeds)
    got = G.influence_propagation(p, seeds)
    np.testing.assert_allclose(got["influenceScores"], want["influenceScores"],
                               rtol=0, atol=1e-6)
    assert got["seeds"] == want["seeds"] and got["converged"] == want["converged"]
    assert abs(got["totalSeedInfluence"] - want["totalSeedInfluence"]) < 1e-5


# ------------------------------------------------------------ communities

def _two_cliques():
    dense = np.zeros((10, 10))
    dense[:5, :5] = dense[5:, 5:] = 1.0
    np.fill_diagonal(dense, 0.0)
    dense[4, 5] = dense[5, 4] = 1.0
    return slt.Matrix.from_dense(dense), slp.Matrix.from_dense(dense)


COMMUNITY_GRAPHS = {
    "two_cliques": _two_cliques,
    "digraph60": lambda: random_digraph(60, 0.1, seed=11),
    "sparse5000": lambda: sparse_digraph(n=5000, out=3, seed=12),
}


@pytest.mark.parametrize("graph", sorted(COMMUNITY_GRAPHS))
def test_communities_bit_identical(graph):
    a, p = COMMUNITY_GRAPHS[graph]()
    for seed in (0, 3):
        np.testing.assert_array_equal(G.label_propagation(p, seed=seed),
                                      JG.label_propagation(a, seed=seed))
        assert G.detect_communities(p, seed=seed) == \
            JG.detect_communities(a, seed=seed)
    assert G.detect_communities(p, num_communities=2) == \
        JG.detect_communities(a, num_communities=2)
    labels = np.random.default_rng(2).integers(0, 4, a.shape[0])
    assert G.modularity(p, labels) == JG.modularity(a, labels)


# ------------------------------------------------------------ centrality

def _random_graph(n, m, seed):
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = r != c
    return _pair_coo(r[keep], c[keep], np.ones(int(keep.sum())), n)


@pytest.mark.parametrize("n,m,nodes", [(50, 220, None), (300, 1500, None),
                                       (600, 2400, [0, 5, 599, 77])])
def test_closeness_bit_identical(n, m, nodes):
    a, p = _random_graph(n, m, seed=n)
    assert C.closeness_centrality(p, nodes) == JC.closeness_centrality(a, nodes)


@pytest.mark.parametrize("n,samples", [(60, None), (300, None), (300, 40),
                                       (600, 300)])
def test_betweenness_matches(n, samples):
    """Device (n >= 192) or host, against the JAX package and the exact host
    Brandes of the same sources."""
    a, p = _random_graph(n, 5 * n, seed=n + 1)
    got = np.asarray(G.betweenness_centrality(p, samples)["betweennessVector"])
    want = np.asarray(JG.betweenness_centrality(a, samples)["betweennessVector"])
    rng = np.random.default_rng(0)
    if samples is None:
        sources, scale = np.arange(n), 1.0
    else:
        sources, scale = rng.choice(n, size=samples, replace=False), n / samples
    exact = C._betweenness_host(p, sources, scale)
    np.testing.assert_array_equal(exact, JC._betweenness_host(a, sources, scale))
    for vec in (got, want):
        np.testing.assert_allclose(vec, exact, rtol=1e-5,
                                   atol=1e-5 * np.abs(exact).max())
    dev = np.asarray(G.betweenness_centrality(
        p, samples, backend="device", chunk=64)["betweennessVector"])
    np.testing.assert_allclose(dev, exact, rtol=1e-5,
                               atol=1e-5 * np.abs(exact).max())


def test_compute_centralities_matches():
    a, p = _random_graph(60, 300, seed=5)
    measures = ("pagerank", "closeness", "betweenness")
    want = JG.compute_centralities(a, measures)
    got = G.compute_centralities(p, measures)
    assert sorted(got) == sorted(want) == sorted(measures)
    assert got["closeness"] == want["closeness"]
    np.testing.assert_allclose(got["pagerank"]["pageRankVector"],
                               want["pagerank"]["pageRankVector"], atol=1e-6)
    np.testing.assert_allclose(got["betweenness"]["betweennessVector"],
                               want["betweenness"]["betweennessVector"],
                               rtol=1e-5)


def test_graph_exports_match():
    assert sorted(G.__all__) == sorted(JG.__all__)
    for name in G.__all__:
        assert callable(getattr(G, name)) or isinstance(getattr(G, name), type)
