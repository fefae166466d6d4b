"""The port's Chebyshev and push solvers against the JAX package's, and the
default ``solve()`` (ADAPTIVE) that reaches them.

Both packages solve the same CSR (``interop.matrix_from_reference``) with
right-hand sides made with numpy from a seed.  Tolerances: both converge
with the same method string; the iteration counts differ by at most one
``check_every`` block (f32 residuals near the threshold may fall on either
side); the solutions agree to 1e-5 * max|x| (both are f32 iterations to a
1e-6 relative residual on diagonally dominant systems, whose solution error
is a small multiple of the residual); each solution's host f64 relative
residual is at most epsilon.  Error codes match exactly.
"""
import numpy as np
import pytest
import torch

import sublinear_tpu as slt
import sublinear_tpu_torch as slp
from sublinear_tpu.errors import SolverError as JaxSolverError
from sublinear_tpu.solvers.push import adjoint_solve as jax_adjoint
from sublinear_tpu_torch.errors import SolverError as PortSolverError
from sublinear_tpu_torch.ops import csr_spmv as K
from sublinear_tpu_torch.solvers.push import adjoint_solve as port_adjoint

from torch_parity import banded_coo, dd_coo, matrix_pair, port_on_cpu, spd_coo

torch.set_num_threads(2)

EPS = 1e-6
CHECK_EVERY = 5
METHODS = ("chebyshev", "forward-push", "backward-push", "bidirectional")
# (route, COO triplets, n, prefer): the JAX package's crossbar kernels (in
# interpret mode) against the port's "csr" route, the dense route and DIA
SYSTEMS = {
    "xbar": (lambda: dd_coo(600, deg=5, seed=41), 600, "xbar"),
    "spd-xbar": (lambda: spd_coo(600, seed=42), 600, "xbar"),
    "dense": (lambda: dd_coo(300, deg=5, seed=43), 300, None),
    "dia": (lambda: banded_coo(600, seed=44), 600, None),
}
CASES = ([("xbar", m) for m in ("chebyshev", "forward-push", "bidirectional")]
         + [("spd-xbar", "backward-push")]
         + [("dense", m) for m in METHODS]
         + [("dia", m) for m in ("chebyshev", "forward-push")])


def _host_rel(a, x, b):
    return np.linalg.norm(a.csr.matvec(x) - b) / np.linalg.norm(b)


def _agree(a, b, rj, rp, method):
    assert rj.converged and rp.converged
    assert rj.method == rp.method == method
    assert abs(rj.iterations - rp.iterations) <= CHECK_EVERY
    np.testing.assert_allclose(rp.solution, rj.solution, rtol=0,
                               atol=1e-5 * np.abs(rj.solution).max())
    for r in (rj, rp):
        assert _host_rel(a, r.solution, b) <= EPS * 1.0001


@pytest.mark.parametrize("route,method", CASES,
                         ids=[f"{r}-{m}" for r, m in CASES])
def test_method_matches(route, method):
    coo, n, prefer = SYSTEMS[route]
    a, p = matrix_pair(*coo(), (n, n), prefer=prefer)
    want_kind = {"xbar": "csr"}.get(a._op_kind(), a._op_kind())
    assert p._op_kind() == want_kind
    b = np.random.default_rng(n).standard_normal(n)
    rj = slt.solve(a, b, method=method, epsilon=EPS, check_every=CHECK_EVERY)
    rp = slp.solve(p, b, method=method, epsilon=EPS, check_every=CHECK_EVERY)
    _agree(a, b, rj, rp, method)


@pytest.mark.parametrize("route", ["xbar", "dense"])
def test_adjoint_solve_matches(route):
    """Backward push on A^T: the same y on the first n entries, sweeps
    within one block, both residuals under the threshold."""
    coo, n, prefer = SYSTEMS[route]
    a, p = matrix_pair(*coo(), (n, n), prefer=prefer)
    e = np.zeros(n)
    e[3] = 1.0
    opts_j = slt.SolverOptions(epsilon=EPS)
    opts_p = slp.SolverOptions(epsilon=EPS)
    yj, kj, resj = jax_adjoint(a, e, opts_j)
    yp, kp, resp = port_adjoint(p, e, opts_p)
    yj, yp = np.asarray(yj)[:n], yp.numpy()[:n]
    assert abs(kj - kp) <= opts_p.check_every
    assert max(resj, resp) <= EPS * np.linalg.norm(e) * 1.0000001
    np.testing.assert_allclose(yp, yj, rtol=0, atol=1e-5 * np.abs(yj).max())
    at = a.csr.transpose()
    assert np.linalg.norm(at.matvec(yp) - e) <= 2 * EPS


def _tridiagonal(pkg, n=2000):
    i = np.arange(n)
    return pkg.Matrix.from_coo(
        np.r_[i, i[:-1], i[1:]], np.r_[i, i[1:], i[:-1]],
        np.r_[np.full(n, 2.2), -np.ones(n - 1), -np.ones(n - 1)], (n, n))


def _e0(n):
    e = np.zeros(n)
    e[0] = 1.0
    return e


ADAPTIVE_INPUTS = {
    # a sparse RHS on an asymmetric DD matrix: forward push
    "random-sparse-e0": (
        lambda pkg: pkg.generate("random-sparse", 1000, seed=7, density=1e-3),
        lambda: _e0(1000), "forward-push"),
    # a weakly dominant symmetric matrix: Chebyshev
    "tridiagonal": (_tridiagonal, lambda: slt.rhs(2000, seed=1), "chebyshev"),
}


@pytest.mark.parametrize("name", sorted(ADAPTIVE_INPUTS))
def test_default_solve_matches(name):
    """The default solve() picks the same method in both packages and
    converges to the same solution."""
    make, rhs, method = ADAPTIVE_INPUTS[name]
    a, p = make(slt), make(slp)
    b = rhs()
    assert slt.select_method(a, b).value == slp.select_method(p, b).value
    rj, rp = slt.solve(a, b), slp.solve(p, b)
    assert rj.converged and rp.converged
    assert rj.method == rp.method == method
    assert abs(rj.iterations - rp.iterations) <= CHECK_EVERY
    np.testing.assert_allclose(rp.solution, rj.solution, rtol=0,
                               atol=1e-5 * np.abs(rj.solution).max())


def _non_dd(pkg):
    return pkg.Matrix.from_dense(
        np.array([[1.0, 2.0, 0.0], [0.5, 1.0, 3.0], [0.0, 1.0, 1.0]]))


@pytest.mark.parametrize("method", METHODS)
def test_non_dd_raises_e001(method):
    with pytest.raises(JaxSolverError) as jexc:
        slt.solve(_non_dd(slt), np.ones(3), method=method)
    with pytest.raises(PortSolverError) as pexc:
        slp.solve(_non_dd(slp), np.ones(3), method=method)
    assert jexc.value.code == pexc.value.code == "E001"


def test_chebyshev_and_push_run_on_the_csr_operator():
    """On the "csr" route both solvers multiply with the CsrOperator (its
    plain version on the CPU: no kernel launch), and a warm start from the
    solution stops within one block."""
    n = 600
    _, p = matrix_pair(*dd_coo(n, deg=5, seed=45), (n, n), prefer="xbar")
    b = np.random.default_rng(46).standard_normal(n)
    before = dict(K.LAUNCHES)
    for method in ("chebyshev", "forward-push"):
        r = slp.solve(p, b, method=method, epsilon=EPS)
        assert r.converged and type(p.op()).__name__ == "CsrOperator"
        warm = slp.solve(p, b, method=method, epsilon=EPS, x0=r.solution)
        assert warm.converged and warm.iterations <= CHECK_EVERY
    assert K.LAUNCHES == before
