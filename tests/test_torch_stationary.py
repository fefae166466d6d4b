"""The port's Jacobi, multicolor Gauss-Seidel and SOR against the JAX
package's, and the greedy coloring they share.

Both packages solve the same CSR (``interop.matrix_from_reference``) with
right-hand sides made with numpy from a seed.  Tolerances: both converge
with the same method string; the iteration counts differ by at most one
``check_every`` block (f32 residuals near the threshold may fall on either
side); the solutions agree to 1e-5 * max|x|; each host f64 relative
residual is at most epsilon; ``matvec_count`` is k (Jacobi) or
k * colors (GS, SOR).  The coloring is bit-identical to the reference's in
both branches (the NumPy loop at n <= 2000, the native loop above).
"""
import numpy as np
import pytest
import torch

import sublinear_tpu as slt
import sublinear_tpu_torch as slp
from sublinear_tpu.errors import SolverError as JaxSolverError
from sublinear_tpu.solvers.jacobi import greedy_coloring as jax_coloring
from sublinear_tpu.solvers.jacobi import solve_sor as jax_sor
from sublinear_tpu_torch import native
from sublinear_tpu_torch.errors import SolverError as PortSolverError
from sublinear_tpu_torch.ops import csr_spmv as K
from sublinear_tpu_torch.solvers import jacobi as J

from torch_parity import banded_coo, dd_coo, matrix_pair, port_on_cpu, spd_coo

torch.set_num_threads(2)

EPS = 1e-6
CHECK_EVERY = 5
METHODS = ("jacobi", "gauss-seidel", "sor")
SYSTEMS = {
    "xbar": (lambda: dd_coo(600, deg=5, seed=51), 600, "xbar"),
    "spd-xbar": (lambda: spd_coo(600, seed=52), 600, "xbar"),
    "dense": (lambda: dd_coo(300, deg=5, seed=53), 300, None),
    "dia": (lambda: banded_coo(600, seed=54), 600, None),
}
CASES = [(r, m) for r in ("xbar", "dense") for m in METHODS] + [
    ("spd-xbar", "gauss-seidel"), ("dia", "jacobi"), ("dia", "sor")]


def _host_rel(a, x, b):
    return np.linalg.norm(a.csr.matvec(x) - b) / np.linalg.norm(b)


@pytest.mark.parametrize("route,method", CASES,
                         ids=[f"{r}-{m}" for r, m in CASES])
def test_method_matches(route, method):
    coo, n, prefer = SYSTEMS[route]
    a, p = matrix_pair(*coo(), (n, n), prefer=prefer)
    want_kind = {"xbar": "csr"}.get(a._op_kind(), a._op_kind())
    assert p._op_kind() == want_kind
    b = np.random.default_rng(n).standard_normal(n)
    rj = slt.solve(a, b, method=method, epsilon=EPS, check_every=CHECK_EVERY,
                   collect_stats=True)
    rp = slp.solve(p, b, method=method, epsilon=EPS, check_every=CHECK_EVERY,
                   collect_stats=True)
    assert rj.converged and rp.converged
    assert rj.method == rp.method == method
    assert abs(rj.iterations - rp.iterations) <= CHECK_EVERY
    np.testing.assert_allclose(rp.solution, rj.solution, rtol=0,
                               atol=1e-5 * np.abs(rj.solution).max())
    for r in (rj, rp):
        assert _host_rel(a, r.solution, b) <= EPS * 1.0001
    colors = 1 if method == "jacobi" else int(J.greedy_coloring(p).max()) + 1
    assert rp.stats.matvec_count == rp.iterations * colors
    assert rj.stats.matvec_count == rj.iterations * colors


@pytest.mark.parametrize("omega", [0.8, 1.2])
def test_sor_omega_matches(omega):
    n = 600
    a, p = matrix_pair(*dd_coo(n, deg=5, seed=55), (n, n), prefer="xbar")
    b = np.random.default_rng(56).standard_normal(n)
    rj = jax_sor(a, b, slt.SolverOptions(epsilon=EPS), omega=omega)
    rp = J.solve_sor(p, b, slp.SolverOptions(epsilon=EPS), omega=omega)
    assert rj.converged and rp.converged and rp.method == "sor"
    assert abs(rj.iterations - rp.iterations) <= CHECK_EVERY
    np.testing.assert_allclose(rp.solution, rj.solution, rtol=0,
                               atol=1e-5 * np.abs(rj.solution).max())


@pytest.mark.parametrize("mode", ["l1", "max", "relative_change", "combined"])
def test_jacobi_convergence_modes_match(mode):
    """Jacobi in the other convergence modes: both converge, stop within
    one block of each other and agree to 1e-5 * max|x|."""
    from sublinear_tpu.types import ConvergenceMode as JaxMode
    from sublinear_tpu_torch.types import ConvergenceMode as PortMode

    n = 300
    a, p = matrix_pair(*dd_coo(n, deg=5, seed=57), (n, n))
    b = np.random.default_rng(58).standard_normal(n)
    rj = slt.solve(a, b, method="jacobi", epsilon=EPS,
                   convergence_mode=JaxMode(mode))
    rp = slp.solve(p, b, method="jacobi", epsilon=EPS,
                   convergence_mode=PortMode(mode))
    assert rj.converged and rp.converged
    assert abs(rj.iterations - rp.iterations) <= CHECK_EVERY
    np.testing.assert_allclose(rp.solution, rj.solution, rtol=0,
                               atol=1e-5 * np.abs(rj.solution).max())


@pytest.mark.parametrize("n", [500, 5000])
def test_greedy_coloring_bit_identical(n):
    """n=500 runs the NumPy loop in both packages, n=5000 the native one."""
    a = slt.generate("random-sparse", n, seed=59, density=6.0 / n)
    p = slp.generate("random-sparse", n, seed=59, density=6.0 / n)
    want = jax_coloring(a)
    got = J.greedy_coloring(p)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if n > J.NATIVE_COLORING_MIN_N:  # the claim covers the native branch
        assert native.available()


def test_native_and_python_coloring_agree():
    """The native loop and the NumPy loop give the same colors."""
    n = 2500
    p = slp.generate("random-sparse", n, seed=60, density=8.0 / n)
    assert native.available()
    csr, t = p.csr, p.T_csr()
    fast = native.greedy_coloring(csr.indptr, csr.indices, t.indptr,
                                  t.indices, n)
    J.NATIVE_COLORING_MIN_N, old = n, J.NATIVE_COLORING_MIN_N
    try:
        slow = J.greedy_coloring(p)
    finally:
        J.NATIVE_COLORING_MIN_N = old
    np.testing.assert_array_equal(fast, slow)
    # a proper coloring: no stored off-diagonal entry joins two equal colors
    rows = csr.row_of_entry()
    off = rows != csr.indices
    assert not np.any(fast[rows[off]] == fast[csr.indices[off]])


def test_color_masks_partition_the_rows():
    colors = np.array([0, 2, 1, 0, 2], dtype=np.int32)
    masks = J.color_masks(colors, 5, torch.device("cpu"))
    assert masks.dtype == torch.bool and masks.shape == (3, 5)
    assert torch.equal(masks.sum(0), torch.ones(5, dtype=torch.int64))
    assert masks[2].nonzero().flatten().tolist() == [1, 4]


def test_gauss_seidel_runs_on_the_csr_operator():
    """On the "csr" route every color's product is the CsrOperator's (its
    plain version on the CPU: no kernel launch)."""
    n = 600
    _, p = matrix_pair(*dd_coo(n, deg=5, seed=61), (n, n), prefer="xbar")
    b = np.random.default_rng(62).standard_normal(n)
    before = dict(K.LAUNCHES)
    r = slp.solve(p, b, method="gauss-seidel", epsilon=EPS)
    assert r.converged and type(p.op()).__name__ == "CsrOperator"
    assert K.LAUNCHES == before


def _non_dd(pkg):
    return pkg.Matrix.from_dense(
        np.array([[1.0, 2.0, 0.0], [0.5, 1.0, 3.0], [0.0, 1.0, 1.0]]))


def test_jacobi_non_dd_raises_e001():
    with pytest.raises(JaxSolverError) as jexc:
        slt.solve(_non_dd(slt), np.ones(3), method="jacobi")
    with pytest.raises(PortSolverError) as pexc:
        slp.solve(_non_dd(slp), np.ones(3), method="jacobi")
    assert jexc.value.code == pexc.value.code == "E001"


def test_jacobi_timeout_raises_e004():
    """The wall-clock timeout runs Jacobi in warm-restarted chunks and
    raises E004 in both packages."""
    for pkg, err in ((slt, JaxSolverError), (slp, PortSolverError)):
        a = pkg.generate("random-sparse", 64, seed=51, density=0.1)
        with pytest.raises(err) as exc:
            pkg.solve(a, pkg.rhs(64, seed=51), method="jacobi", epsilon=1e-30,
                      timeout=0.0, max_iterations=100000,
                      convergence="absolute")
        assert exc.value.code == "E004"


def test_native_coloring_rejects_bad_patterns():
    """The C loop indexes with every column: a column out of range or a
    row pointer of the wrong length raises before it runs."""
    indptr = np.array([0, 1, 2])
    with pytest.raises(ValueError):
        native.greedy_coloring(indptr, np.array([0, 2]), indptr,
                               np.array([0, 1]), 2)
    with pytest.raises(ValueError):
        native.greedy_coloring(indptr[:2], np.array([0]), indptr,
                               np.array([0, 1]), 2)
    np.testing.assert_array_equal(
        native.greedy_coloring(indptr, np.array([1, 0]), indptr,
                               np.array([1, 0]), 2), [0, 1])
