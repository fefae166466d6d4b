"""The port's random-walk estimators against the JAX package's.

The random streams differ (``torch.Generator`` against ``jax.random``), so
estimates are held to statistical bounds, as the JAX package's own tests
hold its walkers (``tests/test_solvers_sublinear.py``): on strongly
dominant systems with an f64 oracle, every strategy's estimate lies within
0.08 of the exact entry (0.05 for plain importance and control variates),
the port's and the reference's estimates of one entry differ by at most
5 standard errors of their difference, stratified and QMC driving keep the
mean variance within 1.25x of iid driving, and control variates cut it
below half.  What is deterministic is held exactly: the sampling tables are
bit-identical to the reference's arrays, the walker cap follows the same
formula, a rerun with one seed is bit-identical, and the blocked walk stops
at the step a walk checked after every step stops at.
"""
import numpy as np
import pytest
import torch

import sublinear_tpu as slt
import sublinear_tpu_torch as slp
from sublinear_tpu.errors import SolverError as JaxSolverError
from sublinear_tpu.solvers import random_walk as JRW
from sublinear_tpu.solvers import sampling as JS
from sublinear_tpu_torch.errors import SolverError as PortSolverError
from sublinear_tpu_torch.solvers import random_walk as RW
from sublinear_tpu_torch.solvers import sampling as S

from torch_parity import dd_coo, matrix_pair, port_on_cpu

torch.set_num_threads(2)

STRATEGIES = ["importance", "uniform", "stratified", "qmc", "adaptive"]


def _strong_dd(n=48, seed=6):
    """The JAX tests' strongly dominant system, in both packages."""
    a = slt.generate("random-sparse", n, seed=seed, density=0.08)
    a = slt.Matrix(a.csr.add_diagonal(2.0))
    p = slp.Matrix(slp.generate("random-sparse", n, seed=seed,
                                density=0.08).csr.add_diagonal(2.0))
    b = slt.rhs(n, seed=seed)
    return a, p, b, np.linalg.solve(a.to_dense(), b)


def _within_se(est_p, var_p, est_j, var_j, walks):
    se = np.sqrt((var_p + var_j) / walks)
    assert np.all(np.abs(est_p - est_j) <= 5 * se + 1e-6), (est_p, est_j, se)


TABLE_ROUTES = {
    "xbar": (lambda: dd_coo(600, deg=5, seed=71), 600, "xbar"),
    "dense": (lambda: dd_coo(300, deg=5, seed=72), 300, None),
}


@pytest.mark.parametrize("route", sorted(TABLE_ROUTES))
def test_sampling_tables_bit_identical(route):
    """The tables on the first n rows (the JAX operators pad their rows)."""
    coo, n, prefer = TABLE_ROUTES[route]
    a, p = matrix_pair(*coo(), (n, n), prefer=prefer)
    tj, tp = JRW.sampling_tables(a), RW.sampling_tables(p)
    for name in ("cols", "cdf", "sign", "S", "mval", "k_row"):
        want = np.asarray(getattr(tj, name))[:n]
        got = getattr(tp, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert tp.n_pad == n
    assert RW.sampling_tables(p) is tp  # cached


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_sampling_strategies_all_unbiased(strategy):
    a, p, b, x_ref = _strong_dd()
    nodes = [0, 7, 33]
    W = 4000
    est_j, var_j, _ = JRW.walk_estimate(
        a, b, nodes, slt.SolverOptions(num_walks=W, seed=3, sampling=strategy))
    est, var, steps = RW.walk_estimate(
        p, b, nodes, slp.SolverOptions(num_walks=W, seed=3, sampling=strategy))
    np.testing.assert_allclose(est, x_ref[nodes], atol=0.08,
                               err_msg=f"strategy={strategy}")
    assert np.all(var >= 0) and steps > 0
    _within_se(est, var, est_j, var_j, W)


@pytest.mark.parametrize("strategy", ["stratified", "qmc"])
def test_stratified_and_qmc_reduce_variance(strategy):
    a, p, b, x_ref = _strong_dd(seed=9)
    nodes = list(range(16))
    base = slp.SolverOptions(num_walks=2000, seed=11, variance_reduction="none")
    _, var_iid, _ = RW.walk_estimate(p, b, nodes, base)
    opts = slp.SolverOptions(num_walks=2000, seed=11, sampling=strategy,
                             variance_reduction="none")
    est, var, _ = RW.walk_estimate(p, b, nodes, opts)
    np.testing.assert_allclose(est, x_ref[nodes], atol=0.08)
    assert var.mean() <= var_iid.mean() * 1.25, (var.mean(), var_iid.mean())


def test_control_variates_reduces_variance():
    """Control variates = exact Neumann head + MC tail: the same
    expectation, tail-only variance."""
    a, p, b, x_ref = _strong_dd(seed=13)
    nodes = list(range(16))
    plain = slp.SolverOptions(num_walks=800, seed=21, variance_reduction="none")
    _, var_plain, _ = RW.walk_estimate(p, b, nodes, plain)
    cv = slp.SolverOptions(num_walks=800, seed=21,
                           variance_reduction="control-variates")
    est, var_cv, _ = RW.walk_estimate(p, b, nodes, cv)
    np.testing.assert_allclose(est, x_ref[nodes], atol=0.05)
    assert var_cv.mean() < var_plain.mean() * 0.5, (var_cv.mean(),
                                                    var_plain.mean())
    est_j, var_j, _ = JRW.walk_estimate(
        a, b, nodes, slt.SolverOptions(num_walks=800, seed=21,
                                       variance_reduction="control-variates"))
    _within_se(est, var_cv, est_j, var_j, 800)


def test_head_partial_sum_matches():
    """The control variate's exact head: T0 products, as in the reference."""
    n = 600
    a, p = matrix_pair(*dd_coo(n, deg=5, seed=73), (n, n), prefer="xbar")
    b = np.random.default_rng(74).standard_normal(n)
    jop, pop = a.op(), p.op()
    cj = jop.inv_diag * a.pad_vector(b)
    cp = pop.inv_diag * p.pad_vector(b)
    want = np.asarray(JRW._head_partial_sum(jop, cj, 8))[:n]
    got = RW._head_partial_sum(pop, cp, 8).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_walker_chunking_matches_oracle(monkeypatch):
    """A tiny SLT_MEMORY_LIMIT_BYTES splits the walker batch into many
    chunks; the cap is the reference's, and estimates stay unbiased across
    chunk seams."""
    monkeypatch.setenv("SLT_MEMORY_LIMIT_BYTES", str(2_000_000))
    _, p, b, x_ref = _strong_dd(seed=14)
    Kmax = int(p.csr.row_nnz().max())
    cap = RW.max_walkers_for_memory(Kmax)
    assert cap == JRW.max_walkers_for_memory(Kmax)
    nodes = list(range(24))
    W = 2000
    assert len(nodes) * W > cap, "test must actually exercise the chunked path"
    est, var, _ = RW.walk_estimate(p, b, nodes,
                                   slp.SolverOptions(num_walks=W, seed=5))
    np.testing.assert_allclose(est, x_ref[nodes], atol=0.08)
    assert np.all(np.isfinite(var))


def test_sampling_tables_raise_e007(monkeypatch):
    _, p, _, _ = _strong_dd(n=200, seed=15)
    monkeypatch.setenv("SLT_MEMORY_LIMIT_BYTES", "1000")
    with pytest.raises(PortSolverError) as exc:
        RW.sampling_tables(p)
    assert exc.value.code == "E007"


def test_multilevel_estimate_matches_oracle():
    _, p, b, x_ref = _strong_dd(seed=4)
    nodes = np.array([1, 5, 40])
    stats = S.SamplingStats()
    est, var, steps = S.multilevel_estimate(
        p, b, nodes, slp.SolverOptions(num_walks=4000, seed=5), stats=stats)
    np.testing.assert_allclose(est, x_ref[nodes], atol=0.08)
    assert stats.total_walks > 0 and len(stats.phases) == 3
    assert stats.phases[2]["walks"] < stats.phases[0]["walks"]
    # the same level boundaries and walker counts as the reference
    ref = JS.SamplingStats()
    a, _, _, _ = _strong_dd(seed=4)
    JS.multilevel_estimate(a, b, nodes, slt.SolverOptions(num_walks=4000,
                                                          seed=5), stats=ref)
    assert ([(q["phase"], q["walks"]) for q in stats.phases]
            == [(q["phase"], q["walks"]) for q in ref.phases])


def test_adaptive_allocates_by_variance():
    _, p, b, x_ref = _strong_dd(seed=8)
    nodes = np.arange(8)
    stats = S.SamplingStats()
    est, var, _ = S.adaptive_walk_estimate(
        p, b, nodes, slp.SolverOptions(num_walks=2000, seed=7), stats=stats)
    np.testing.assert_allclose(est, x_ref[nodes], atol=0.08)
    assert [q["phase"] for q in stats.phases] == ["pilot", "refine"]
    assert stats.total_walks == pytest.approx(8 * 2000, rel=0.01)


@pytest.mark.parametrize("strategy", ["importance", "uniform", "qmc"])
def test_walks_rerun_bit_identical(strategy):
    _, p, b, _ = _strong_dd(seed=16)
    starts = np.repeat(np.arange(10), 50)
    opts = slp.SolverOptions(seed=9, sampling=strategy)
    acc1, t1 = RW.run_walks(p, b, starts, opts, group=50)
    acc2, t2 = RW.run_walks(p, b, starts, opts, group=50)
    np.testing.assert_array_equal(acc1, acc2)
    assert t1 == t2
    acc3, _ = RW.run_walks(p, b, starts, slp.SolverOptions(
        seed=10, sampling=strategy), group=50)
    assert not np.array_equal(acc1, acc3)


@pytest.mark.parametrize("max_len", [3, 512])
def test_blocked_walk_stops_where_a_per_step_walk_stops(monkeypatch, max_len):
    """Blocks of WALK_BLOCK steps with the on-device alive flag give the
    walkers and the step count of a walk whose flag is read after every
    step (WALK_BLOCK = 1), both when the weights die out and when the
    length cap ends the walk."""
    _, p, b, _ = _strong_dd(seed=17)
    starts = np.repeat(np.arange(12), 40)
    opts = slp.SolverOptions(seed=4, max_walk_length=max_len)
    acc_b, t_b = RW.run_walks(p, b, starts, opts, group=40)
    monkeypatch.setattr(RW, "WALK_BLOCK", 1)
    acc_s, t_s = RW.run_walks(p, b, starts, opts, group=40)
    np.testing.assert_array_equal(acc_b, acc_s)
    assert t_b == t_s
    assert t_b == 3 if max_len == 3 else 3 < t_b < max_len


def test_solve_random_walk_estimates_solution():
    _, p, b, x_ref = _strong_dd(seed=5)
    r = slp.solve(p, b, method="random-walk", epsilon=0.05, num_walks=2000,
                  seed=1, raise_on_fail=False)
    assert r.method == "random-walk" and r.iterations > 0
    err = np.abs(r.solution - x_ref)
    assert err.max() < 0.08 * max(np.abs(x_ref).max(), 1.0)


def _non_dd(pkg):
    return pkg.Matrix.from_dense(
        np.array([[1.0, 2.0, 0.0], [0.5, 1.0, 3.0], [0.0, 1.0, 1.0]]))


def test_random_walk_non_dd_raises_e001():
    with pytest.raises(JaxSolverError) as jexc:
        slt.solve(_non_dd(slt), np.ones(3), method="random-walk")
    with pytest.raises(PortSolverError) as pexc:
        slp.solve(_non_dd(slp), np.ones(3), method="random-walk")
    assert jexc.value.code == pexc.value.code == "E001"
