"""``sublinear_tpu_torch.solve`` against ``sublinear_tpu.solve`` with
``method="neumann"``, on the dense route and on the sparse-kernel route.

Both solutions meet the threshold; they agree to 1e-5 relative (max-norm)
on the first n entries, because both are f32 iterations to a 1e-6 relative
residual; the iteration counts differ by at most one ``check_every`` block
(f32 residuals near the threshold may fall on either side)."""
import numpy as np
import pytest
import torch

import sublinear_tpu as slt
import sublinear_tpu_torch as slp
from sublinear_tpu.types import ConvergenceMode as JaxMode
from sublinear_tpu_torch.ops import csr_spmv as K
from sublinear_tpu_torch.types import ConvergenceMode as PortMode

from torch_parity import dd_coo, matrix_pair, port_on_cpu

torch.set_num_threads(2)


def _agree(a, b, rj, rp, check_every, eps=1e-6):
    assert rj.converged and rp.converged
    assert abs(rj.iterations - rp.iterations) <= check_every
    np.testing.assert_allclose(rp.solution, rj.solution,
                               rtol=0, atol=1e-5 * np.abs(rj.solution).max())
    for r in (rj, rp):
        rel = np.linalg.norm(a.csr.matvec(r.solution) - b) / np.linalg.norm(b)
        assert rel <= eps * 1.0001, rel


@pytest.mark.parametrize("mode", ["l2", "l1", "max", "relative_change",
                                  "combined"])
def test_dense_route_matches(mode):
    """The canonical drive: generate("random-sparse", 1000, seed=7,
    density=1e-3), dense route, in every convergence mode."""
    a = slt.generate("random-sparse", 1000, seed=7, density=1e-3)
    p = slp.generate("random-sparse", 1000, seed=7, density=1e-3)
    assert a._op_kind() == p._op_kind() == "dense"
    b = slt.rhs(1000, seed=7)
    rj = slt.solve(a, b, method="neumann", epsilon=1e-6,
                   convergence_mode=JaxMode(mode))
    rp = slp.solve(p, b, method="neumann", epsilon=1e-6,
                   convergence_mode=PortMode(mode))
    assert rp.method == rj.method == "neumann"
    if mode in ("l2", "combined"):
        _agree(a, b, rj, rp, 5)
    else:
        assert rj.converged and rp.converged
        assert abs(rj.iterations - rp.iterations) <= 5
        np.testing.assert_allclose(rp.residual, rj.residual, rtol=0.05)


@pytest.mark.parametrize("check_every", [1, 5])
def test_sparse_route_matches(check_every):
    """n=600 with prefer="xbar": the JAX package's crossbar kernels against
    the port's CSR kernels (chained when check_every > 1)."""
    n = 600
    a, p = matrix_pair(*dd_coo(n, deg=5, seed=31), (n, n), prefer="xbar")
    assert p._op_kind() == "csr" and p.op().chain_ready
    b = np.random.default_rng(32).standard_normal(n)
    rj = slt.solve(a, b, method="neumann", epsilon=1e-6,
                   check_every=check_every)
    rp = slp.solve(p, b, method="neumann", epsilon=1e-6,
                   check_every=check_every)
    _agree(a, b, rj, rp, check_every)
    assert rp.error_bounds is not None and rp.error_bounds.is_valid()


def test_warm_start_and_stats():
    n = 600
    _, p = matrix_pair(*dd_coo(n, deg=5, seed=33), (n, n), prefer="xbar")
    b = np.random.default_rng(34).standard_normal(n)
    cold = slp.solve(p, b, method="neumann", epsilon=1e-6, collect_stats=True)
    warm = slp.solve(p, b, method="neumann", epsilon=1e-6,
                     x0=cold.solution)
    assert warm.iterations <= cold.iterations
    assert cold.stats.backend == "cpu" and cold.stats.matvec_count > 0


def test_adaptive_runs_neumann():
    p = slp.generate("random-sparse", 1000, seed=7, density=1e-3)
    b = slp.rhs(1000, seed=7)
    assert slp.select_method(p, b) == slp.Method.NEUMANN
    r = slp.solve(p, b, method="adaptive", epsilon=1e-6)
    assert r.converged and r.method == "neumann"


def test_unported_method_names_the_roadmap():
    """Every method is ported now: each Method dispatches to its solver and
    none raises NotImplementedError (the test keeps its name from when the
    unported methods named their ROADMAP item)."""
    p = slp.generate("random-sparse", 200, seed=1, density=0.05)
    b = slp.rhs(200, seed=1)
    for m in slp.Method:
        r = slp.solve(p, b, method=m.value, epsilon=1e-3, num_walks=64,
                      raise_on_fail=False)
        assert r.solution.shape == (200,), m


@pytest.mark.parametrize("method", [m.value for m in slp.Method])
def test_every_method_dispatches(method):
    """Each Method returns the method string the JAX package returns for it
    on the same system."""
    a = slt.generate("random-sparse", 200, seed=1, density=0.05)
    p = slp.generate("random-sparse", 200, seed=1, density=0.05)
    b = slt.rhs(200, seed=1)
    kw = dict(epsilon=1e-3, num_walks=64, raise_on_fail=False)
    rj = slt.solve(a, b, method=method, **kw)
    rp = slp.solve(p, b, method=method, **kw)
    assert rp.method == rj.method
    assert np.all(np.isfinite(rp.solution)) and rp.solution.shape == (200,)


def test_timeout_path_converges():
    p = slp.generate("random-sparse", 300, seed=2, density=0.02)
    b = slp.rhs(300, seed=2)
    r = slp.solve(p, b, method="neumann", epsilon=1e-6, timeout=60.0)
    assert r.converged


def test_cpu_solve_launches_no_kernel():
    n = 600
    _, p = matrix_pair(*dd_coo(n, deg=5, seed=35), (n, n), prefer="xbar")
    before = dict(K.LAUNCHES)
    slp.solve(p, np.ones(n), method="neumann", epsilon=1e-6)
    assert K.LAUNCHES == before


@pytest.mark.parametrize("shape", [(100_000,), (300, 7), (0,)])
def test_host_norm_l2_matches_the_jax_package(shape):
    """The threshold's 2-norm agrees with the JAX package's
    (``np.linalg.norm``) to 1e-14 relative: both add the same squares, in
    another order."""
    from sublinear_tpu.solvers import base as jbase
    from sublinear_tpu_torch.solvers import base as pbase

    v = np.random.default_rng(17).uniform(-1.0, 1.0, shape)
    want = jbase.host_norm(v, "l2")
    assert pbase.host_norm(v, "l2") == pytest.approx(want, rel=1e-14, abs=0.0)


def test_host_norm_keeps_no_thread_busy():
    """A solve's threshold norm runs on the calling thread alone: the
    process's CPU time over a run of solve-paced norms of a 100k vector stays
    near the wall time (a BLAS dot woke every core of the host, whose
    threads then spun between calls)."""
    import resource
    import time

    from sublinear_tpu_torch.solvers import base as pbase

    v = np.random.default_rng(5).uniform(-1.0, 1.0, 100_000)
    time.sleep(0.5)  # threads that earlier BLAS calls woke go back to sleep

    def cpu():
        r = resource.getrusage(resource.RUSAGE_SELF)
        return r.ru_utime + r.ru_stime

    c0, t0 = cpu(), time.perf_counter()
    for _ in range(300):
        pbase.host_norm(v, "l2")
        pause = time.perf_counter() + 1e-3  # the rest of a solve's host work
        while time.perf_counter() < pause:
            pass
    wall = time.perf_counter() - t0
    assert cpu() - c0 <= 2.0 * wall, (cpu() - c0, wall)
