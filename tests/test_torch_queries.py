"""The port's query layer against the JAX package's, on the CPU.

The deterministic queries (the inverse entry by Neumann, the backward-push
entry, the bidirectional functional estimate, the batched deterministic
entries) agree within 1e-5 relative (f32 sums taken in another order).  The
walker queries use other random streams, so they are held to statistical
bounds and to the exact solve, never to the JAX package's samples: every
estimate within 5 standard errors of the exact entry (+1e-6) and within 5
standard errors of the JAX package's estimate of the same entry.  Error
codes match exactly.  The temporal dicts are equal except for the fields
that carry a measured time.
"""
import numpy as np
import pytest
import torch
from scipy.sparse import csr_matrix
from scipy.sparse.linalg import spsolve

import sublinear_tpu as slt
import sublinear_tpu_torch as slp
from sublinear_tpu import queries as JQ
from sublinear_tpu.errors import SolverError as JaxSolverError
from sublinear_tpu.solvers import random_walk as JRW
from sublinear_tpu_torch import queries as Q
from sublinear_tpu_torch.errors import SolverError as PortSolverError
from sublinear_tpu_torch.solvers import random_walk as RW

from torch_parity import dd_coo, matrix_pair, port_on_cpu

torch.set_num_threads(2)

RTOL = 1e-5


def strong_dd(n=48, seed=5):
    """tests/test_queries.py's system, in both packages, with its f64
    solution."""
    a = slt.Matrix(slt.generate("random-sparse", n, seed=seed,
                                density=0.08).csr.add_diagonal(2.0))
    p = slp.Matrix(slp.generate("random-sparse", n, seed=seed,
                                density=0.08).csr.add_diagonal(2.0))
    b = slt.rhs(n, seed=seed)
    return a, p, b, np.linalg.solve(a.to_dense(), b)


def sparse_dd(n=5000, seed=21):
    """A strictly DD system on the port's "csr" route."""
    a, p = matrix_pair(*dd_coo(n, deg=5, seed=seed), (n, n))
    assert p._op_kind() == "csr"
    return a, p, slt.rhs(n, seed=seed)


SYSTEMS = {"strong48": lambda: strong_dd()[:3], "sparse5000": sparse_dd}


def _close(got, want, rtol=RTOL):
    assert abs(got - want) <= rtol * max(abs(want), 1e-30), (got, want)


@pytest.mark.parametrize("system", sorted(SYSTEMS))
@pytest.mark.parametrize("method", ["neumann", "backward-push"])
def test_deterministic_entry_matches(system, method):
    a, p, b = SYSTEMS[system]()
    for row, col in ((3, 11), (0, 0), (a.shape[0] - 1, 7)):
        opts = dict(options=None) if method == "backward-push" else {}
        want = JQ.estimate_entry(a, b, row, col, method=method, **opts)
        got = Q.estimate_entry(p, b, row, col, method=method, **opts)
        _close(got.estimate, want.estimate)
        _close(got.confidence, want.confidence, rtol=1e-3)
        assert got.method == want.method and got.variance == want.variance
        assert got.confidence_level == want.confidence_level
        assert sorted(got.to_dict()) == sorted(want.to_dict())


def test_entries_against_the_exact_solution():
    a, p, b, x = strong_dd(seed=6)
    inv = np.linalg.inv(a.to_dense())
    opts = slp.SolverOptions(epsilon=1e-8)
    est = Q.estimate_entry(p, b, 3, 11, method="neumann", options=opts)
    assert abs(est.estimate - inv[3, 11]) < 1e-4
    est = Q.estimate_entry(p, b, 5, method="backward-push", options=opts)
    assert abs(est.estimate - x[5]) < 1e-3
    assert est.confidence >= 0


@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_deterministic_entries_match(system):
    a, p, b = SYSTEMS[system]()
    rows = [0, 5, 9, 17, 33]
    want = JQ.estimate_entries(a, b, rows, method="neumann",
                               options=slt.SolverOptions(epsilon=1e-8))
    got = Q.estimate_entries(p, b, rows, method="neumann",
                             options=slp.SolverOptions(epsilon=1e-8))
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("system", sorted(SYSTEMS))
@pytest.mark.parametrize("budget", [None, 200])
def test_functional_matches(system, budget):
    a, p, b = SYSTEMS[system]()
    t = slt.rhs(a.shape[0], seed=100)
    want = JQ.estimate_functional(a, b, t, budget=budget)
    got = Q.estimate_functional(p, b, t, budget=budget)
    scale = max(abs(want["estimate"]), 1.0)
    assert abs(got["estimate"] - want["estimate"]) <= RTOL * scale
    for key in ("forwardResidual", "backwardResidual", "errorBound"):
        assert abs(got[key] - want[key]) <= 1e-3 * want[key] + 1e-6, key
    for side in ("forward", "backward"):
        assert abs(got["sweeps"][side] - want["sweeps"][side]) <= 5
    x = spsolve(csr_matrix(p.to_dense() if a.shape[0] <= 100 else (
        p.csr.data, p.csr.indices, p.csr.indptr), shape=p.shape), b)
    exact = float(t @ x)
    assert abs(got["estimate"] - exact) < 1e-3 * max(abs(exact), 1.0) \
        + got["errorBound"]


def test_walker_entries_statistical():
    """Walker estimates (estimate_entries and estimate_entry) within 5
    standard errors of the exact entries and of the JAX package's."""
    a, p, b, x = strong_dd(seed=8)
    rows = np.array([0, 5, 9, 17, 33])
    W = 4000
    po = slp.SolverOptions(num_walks=W, seed=4)
    est = Q.estimate_entries(p, b, rows, options=po)
    est2, var, _ = RW.walk_estimate(p, b, rows, po)
    np.testing.assert_array_equal(est, est2)  # one seed, one batch
    est_j, var_j, _ = JRW.walk_estimate(a, b, rows,
                                        slt.SolverOptions(num_walks=W, seed=4))
    np.testing.assert_array_equal(
        est_j, JQ.estimate_entries(a, b, rows,
                                   options=slt.SolverOptions(num_walks=W, seed=4)))
    se = np.sqrt(var / W)
    assert np.all(np.abs(est - x[rows]) <= 5 * se + 1e-6)
    assert np.all(np.abs(est - est_j) <= 5 * np.sqrt((var + var_j) / W) + 1e-6)
    one = Q.estimate_entry(p, b, 7, method="random-walk", confidence=0.99,
                           options=slp.SolverOptions(num_walks=W, seed=3))
    ref = JQ.estimate_entry(a, b, 7, method="random-walk", confidence=0.99,
                            options=slt.SolverOptions(num_walks=W, seed=3))
    assert abs(one.estimate - x[7]) <= 5 * np.sqrt(one.variance / W) + 1e-6
    assert abs(one.estimate - ref.estimate) <= 5 * np.sqrt(
        (one.variance + ref.variance) / W) + 1e-6
    # the CI half-width is z * sqrt(var / walks) with the 99% z
    assert one.confidence == pytest.approx(2.576 * np.sqrt(one.variance / W))
    assert one.confidence_level == ref.confidence_level == 0.99
    assert one.method == ref.method == "random-walk"


ERRORS = {
    "row": lambda q, m, b: q.estimate_entry(m, b, row=999),
    "negative row": lambda q, m, b: q.estimate_entry(m, b, row=-1),
    "column": lambda q, m, b: q.estimate_entry(m, b, row=0, column=48),
    "rows": lambda q, m, b: q.estimate_entries(m, b, [0, 48]),
    "method": lambda q, m, b: q.estimate_entry(m, b, row=0, method="nope"),
    "functional": lambda q, m, b: q.estimate_functional(m, b, np.ones(3)),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_error_codes_match(case):
    a, p, b, _ = strong_dd()
    with pytest.raises(JaxSolverError) as jexc:
        ERRORS[case](JQ, a, b)
    with pytest.raises(PortSolverError) as pexc:
        ERRORS[case](Q, p, b)
    assert jexc.value.code == pexc.value.code
    assert type(jexc.value).__name__ == type(pexc.value).__name__


# ------------------------------------------------------------ temporal

TIMED = {"computeTimeMs", "temporalAdvantageMs", "effectiveVelocity",
         "effectiveVelocityRatio", "summary", "valid"}


def _untimed(d):
    return {k: v for k, v in d.items() if k not in TIMED}


def test_light_travel_matches():
    for km in (10_900, 35_786, 1.5):
        assert Q.light_travel_ms(km) == JQ.light_travel_ms(km)
        for size in (2, 1000, 10**6):
            assert Q.calculate_light_travel(km, size) == \
                JQ.calculate_light_travel(km, size)
    assert abs(Q.light_travel_ms(10_900) - 36.36) < 0.05


def test_predict_with_temporal_advantage_matches():
    a, p, b, _ = strong_dd(seed=10)
    want = JQ.predict_with_temporal_advantage(a, b, distance_km=10_900)
    got = Q.predict_with_temporal_advantage(p, b, distance_km=10_900)
    assert sorted(got) == sorted(want)
    sol_g, sol_w = np.asarray(got.pop("solution")), np.asarray(want.pop("solution"))
    np.testing.assert_allclose(sol_g, sol_w, rtol=0,
                               atol=RTOL * np.abs(sol_w).max())
    res_g, res_w = got.pop("residual"), want.pop("residual")
    # f32 residuals near the floor: within 1e-6 of ||b|| of each other
    assert abs(res_g - res_w) <= 1e-6 * np.linalg.norm(b)
    assert _untimed(got) == _untimed(want)
    assert got["computeTimeMs"] > 0
    assert got["temporalAdvantageMs"] == pytest.approx(
        got["lightTravelTimeMs"] - got["computeTimeMs"])
    # a dense list input goes through Matrix.from_dense
    dense = Q.predict_with_temporal_advantage(p.to_dense(), b)
    np.testing.assert_allclose(dense["solution"], sol_g, atol=1e-6)


@pytest.mark.parametrize("size", [128, 256])
def test_validate_and_demonstrate_match(size):
    want = JQ.validate_temporal_advantage(size=size)
    got = Q.validate_temporal_advantage(size=size)
    assert _untimed(got) == _untimed(want) and got["converged"]
    assert isinstance(got["valid"], bool)
    for scenario in ("trading", "satellite", "unknown"):
        w = JQ.demonstrate_temporal_lead(scenario, size=size)
        g = Q.demonstrate_temporal_lead(scenario, size=size)
        assert g["scenario"] == w["scenario"]
        assert _untimed(g["demonstration"]) == _untimed(w["demonstration"])
    g = Q.demonstrate_temporal_lead("network", custom_distance=500.0, size=size)
    assert g["scenario"]["distanceKm"] == 500.0


def test_prove_temporal_lead_matches():
    want = JQ.prove_temporal_lead(size=128, distance_km=10_900)
    got = Q.prove_temporal_lead(size=128, distance_km=10_900)
    assert got["parameters"] == want["parameters"]
    assert got["theorem"] == want["theorem"] and got["caveat"] == want["caveat"]
    assert len(got["steps"]) == len(want["steps"]) == 5
    for g, w in zip(got["steps"], want["steps"]):
        assert g["step"] == w["step"] and g["basis"] == w["basis"]
        if g["step"] in (1, 2, 3):  # the steps that carry no measured time
            assert g["claim"] == w["claim"]


def test_query_exports_match():
    assert sorted(Q.__all__) == sorted(JQ.__all__)
