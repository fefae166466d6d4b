"""The port's serving solvers against the JAX package's: iterative
refinement, ``PreparedSolver``, ``streaming_solve`` with live RHS updates,
the row-panel ``StreamingOperator`` with ``solve_streaming``, and the
accurate reductions.

Tolerances: ``solve_refined`` reaches the 1e-12 relative residual the
reference's host path reaches (host f64 check), with the same method
string; a prepared solve equals the port's ``solve()`` of the same b bit
for bit (the same runner) and matches the reference's iterations within one
``check_every`` block; ``streaming_solve`` yields the reference's chunk
sequence (iterations, converged flags, RHS versions, and the residuals of
the chunks before convergence within 5%);
the streaming operator cuts the same panels as the reference for the same
budget, its product equals the host f64 product within f32 rounding
(1e-5 of max |y|), and ``solve_streaming`` takes the reference's
iterations; the reductions agree with the reference's compensated f32
sums within 2e-7 of the sum of the magnitudes, and the port's f64
accumulation is within half an f32 ulp of the exact sum.
"""
import numpy as np
import pytest
import torch

import sublinear_tpu as slt
import sublinear_tpu_torch as slp
from sublinear_tpu.errors import SolverError as JaxSolverError
from sublinear_tpu.formats import streaming as JFS
from sublinear_tpu.ops import reductions as JR
from sublinear_tpu.solvers.prepared import PreparedSolver as JaxPrepared
from sublinear_tpu.solvers.refine import solve_refined as jax_refined
from sublinear_tpu.solvers.streaming import StreamControl as JaxControl
from sublinear_tpu.solvers.streaming import streaming_solve as jax_stream
from sublinear_tpu_torch.errors import SolverError as PortSolverError
from sublinear_tpu_torch.formats import streaming as FS
from sublinear_tpu_torch.ops import reductions as R
from sublinear_tpu_torch.solvers.prepared import PreparedSolver
from sublinear_tpu_torch.solvers.refine import DeviceResidual, solve_refined
from sublinear_tpu_torch.solvers.streaming import (StreamControl,
                                                   _probe_verify,
                                                   streaming_solve)
from sublinear_tpu_torch.types import DeltaUpdate, SolutionChunk

from torch_parity import dd_coo, matrix_pair, port_on_cpu, spd_coo

torch.set_num_threads(2)

CHECK_EVERY = 5


def _pair(n=96, seed=31, density=0.08):
    a = slt.generate("random-sparse", n, seed=seed, density=density)
    p = slp.generate("random-sparse", n, seed=seed, density=density)
    return a, p, slt.rhs(n, seed=seed)


def _host_rel(a, x, b):
    return np.linalg.norm(a.csr.matvec(x) - b) / np.linalg.norm(b)


@pytest.mark.parametrize("method", [None, "bicgstab"])
def test_refined_reaches_1e12(method):
    a, p, b = _pair(n=512, seed=33, density=0.02)
    opts_j = slt.SolverOptions(epsilon=1e-12)
    rj = jax_refined(a, b, opts_j, method=method, max_refinements=6,
                     residual="host")
    rp = solve_refined(p, b, slp.SolverOptions(epsilon=1e-12), method=method,
                       max_refinements=6)
    assert rj.converged and rp.converged
    assert rp.method == rj.method
    assert _host_rel(a, rp.solution, b) < 5e-12
    np.testing.assert_allclose(rp.solution, rj.solution, rtol=1e-8,
                               atol=1e-10)


def test_refined_absolute_mode_and_e002():
    a, p, b = _pair(n=64, seed=32, density=0.1)
    r = solve_refined(p, 1e3 * b, slp.SolverOptions(
        epsilon=1e-5, convergence="absolute"))
    assert r.converged
    assert np.linalg.norm(a.to_dense() @ r.solution - 1e3 * b) < 1.1e-5
    for refine, err, A in ((jax_refined, JaxSolverError, a),
                           (solve_refined, PortSolverError, p)):
        with pytest.raises(err) as exc:
            refine(A, b, (slt if err is JaxSolverError else slp).SolverOptions(
                epsilon=1e-15), max_refinements=0)
        assert exc.value.code == "E002"


def test_device_residual_is_f64():
    """The device path's residual evaluator, run on the CPU: b - A x in f64
    equal to the host f64 product within f64 rounding."""
    a, p, b = _pair(n=300, seed=34, density=0.03)
    x = np.random.default_rng(35).standard_normal(300)
    r = DeviceResidual(p, b)(torch.as_tensor(x))
    assert r.dtype == torch.float64
    want = b - a.csr.matvec(x)
    np.testing.assert_allclose(r.numpy(), want, rtol=0,
                               atol=1e-13 * np.abs(want).max())


PREPARED = ["neumann", "conjugate-gradient", "jacobi", "chebyshev",
            "forward-push"]


@pytest.mark.parametrize("method", PREPARED)
def test_prepared_equals_solve(method):
    """n=600 on the "csr" route: a prepared solve runs solve()'s runner
    (the Neumann chain, the chained CG on the SPD matrix)."""
    n = 600
    coo = spd_coo(n, seed=36) if method == "conjugate-gradient" else dd_coo(
        n, deg=5, seed=37)
    a, p = matrix_pair(*coo, (n, n), prefer="xbar")
    ps = PreparedSolver(p, method)
    pj = JaxPrepared(a, method)
    for seed in (1, 2):
        b = np.random.default_rng(seed).standard_normal(n)
        rp = ps.solve(b)
        rs = slp.solve(p, b, method=method, raise_on_fail=False)
        rj = pj.solve(b)
        assert rp.converged and rs.converged and rj.converged
        assert rp.method == rj.method == method
        assert rp.iterations == rs.iterations
        np.testing.assert_array_equal(rp.solution, rs.solution)
        assert abs(rp.iterations - rj.iterations) <= CHECK_EVERY


def test_prepared_adaptive_warm_start_and_errors():
    a, p, b = _pair(n=64, seed=61, density=0.1)
    ps = PreparedSolver(p)  # adaptive resolves once
    assert ps.method == JaxPrepared(a).method
    r1 = ps.solve(b)
    assert r1.converged
    r2 = ps.solve(b + 1e-3, x0=r1.solution)
    assert r2.converged and r2.iterations <= r1.iterations + 2
    with pytest.raises(PortSolverError) as pexc:
        PreparedSolver(p, method="bmssp")
    with pytest.raises(JaxSolverError) as jexc:
        JaxPrepared(a, method="bmssp")
    assert pexc.value.code == jexc.value.code
    assert type(pexc.value).__name__ == "InvalidParametersError"


def _stream(stream, control_cls, A, b, opts, push_after=0):
    control = control_cls()
    out = []
    for i, ch in enumerate(stream(A, b, opts, method="conjugate-gradient",
                                  chunk_iters=5, control=control,
                                  verify_every=2)):
        out.append(ch)
        if i == push_after:
            control.push_delta([1, 2], [0.5, -0.5])
    return out


def test_streaming_solve_chunks_match():
    a, p, b = _pair(n=200, seed=38, density=0.03)
    cj = _stream(jax_stream, JaxControl, a, b, slt.SolverOptions(epsilon=1e-8))
    cp = _stream(streaming_solve, StreamControl, p, b,
                 slp.SolverOptions(epsilon=1e-8))
    assert len(cp) == len(cj) >= 2
    for x, y in zip(cp, cj):
        assert isinstance(x, SolutionChunk)
        assert (x.iteration, x.converged, x.rhs_version) == (
            y.iteration, y.converged, y.rhs_version)
        if not x.converged:  # converged chunks sit at the f32 floor
            np.testing.assert_allclose(x.residual, y.residual, rtol=0.05)
        assert (x.verification is None) == (y.verification is None)
    assert cp[-1].converged and cp[-1].rhs_version == 1
    b2 = b.copy()
    b2[[1, 2]] += [0.5, -0.5]
    # the stream converged to the updated b (in f32: its floor, not 1e-8)
    assert _host_rel(a, cp[-1].solution, b2) <= 1e-6
    assert cp[-1].to_dict()["rhsVersion"] == 1


def test_probe_verify_and_delta():
    a, p, b = _pair(n=100, seed=39, density=0.05)
    x = np.linalg.solve(a.to_dense(), b)
    got = _probe_verify(p, x, b, 16, 1e-6, seed=3)
    assert got["verified"] and got["probe_count"] == 16
    bad = _probe_verify(p, x + 1.0, b, 16, 1e-6, seed=3)
    assert not bad["verified"]
    d = StreamControl().push_delta([1], [2.0])
    assert isinstance(d, DeltaUpdate) and d.indices.dtype == np.int64


@pytest.mark.parametrize("budget", [4096, 20_000, 1 << 20])
def test_streaming_operator_panels_match(budget):
    a, p, _ = _pair(n=800, seed=7, density=5e-3)
    oj = JFS.StreamingOperator(a.csr, budget)
    op = FS.StreamingOperator(p.csr, budget, device="cpu")
    assert op.n_panels == oj.n_panels
    x = np.random.default_rng(40).standard_normal(800)
    want = p.csr.matvec(x)
    for got in (op.matvec(x), oj.matvec(x)):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(op.offdiag_matvec(x),
                               want - p.diagonal_vector() * x, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # each panel is a CsrOperator of its rows by all m columns
    for r0, rows, panel in op.panels:
        assert panel.shape == (rows, 800) and not panel.diag_split


def test_solve_streaming_matches():
    a, p, b = _pair(n=800, seed=7, density=5e-3)
    rj = JFS.solve_streaming(a, b)
    rp = FS.solve_streaming(p, b, panel_budget=4096)
    assert rj.converged and rp.converged
    assert rp.method == rj.method == "neumann-streaming"
    assert rp.iterations == rj.iterations
    np.testing.assert_allclose(rp.solution, rj.solution, rtol=0,
                               atol=1e-5 * np.abs(rj.solution).max())


def test_reductions_match():
    rng = np.random.default_rng(41)
    v = rng.standard_normal(5000).astype(np.float32) * 1e3
    w = rng.standard_normal(5000).astype(np.float32)
    tv, tw = torch.as_tensor(v), torch.as_tensor(w)
    exact = float(np.sum(v.astype(np.float64)))
    for got, want in ((R.kahan_sum(tv), JR.kahan_sum(v)),
                      (R.compensated_dot(tv, tw), JR.compensated_dot(v, w)),
                      (R.compensated_norm(tv), JR.compensated_norm(v))):
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(want), rtol=0,
                                   atol=2e-7 * np.abs(v).sum())
    assert abs(float(R.kahan_sum(tv)) - exact) <= abs(
        float(np.float32(exact)) - exact) + 1e-9
