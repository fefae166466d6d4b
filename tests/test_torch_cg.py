"""The port's CG path against the JAX package's: ``cg_chain`` (plain version
on the CPU) against ``XbarOperator.cg_chain`` (``_cg_chain_call``, interpret
mode), the chain's own contract, and ``solve`` with ``method="cg"``,
``"bicgstab"`` and ``"adaptive"``.

Tolerances:
- cg_chain state vectors: rtol 2e-4, atol 2e-5, as tests/test_xbar.py holds
  the chain to an explicit PCG loop (f32 CG steps amplify differences of
  summation order); rz the same; res2 rtol 1e-5 against ||r||^2 of the
  returned r (the port sums it in f64, the JAX kernel in f32);
- solves: both converged, solutions within 1e-5 * max|x| (both are f32
  iterations to a 1e-6 relative residual), host f64 relative residual of
  each within 1e-6, and iteration counts within one chunk of the schedule
  they stopped in (one step on the per-step path).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sublinear_tpu as slt
import sublinear_tpu_torch as slp
from sublinear_tpu.types import ConvergenceMode as JaxMode
from sublinear_tpu_torch.formats.csr import CSR
from sublinear_tpu_torch.ops import csr_spmv as K
from sublinear_tpu_torch.types import ConvergenceMode as PortMode

from torch_parity import dd_coo, matrix_pair, padded, port_on_cpu, spd_coo, t32

torch.set_num_threads(2)

N = 500
VEC_TOL = dict(rtol=2e-4, atol=2e-5)
OUTPUTS = ("x", "r", "p", "rz", "res2")


def _start(op, b):
    """PCG state at x0 = 0: (x, r, p = z, rz) in the port's operator."""
    r = t32(b)
    z = op.inv_diag * r
    return torch.zeros_like(r), r, z, K.dot64(r, z)


@pytest.fixture(scope="module")
def system():
    a, p = matrix_pair(*spd_coo(N, seed=3), (N, N), prefer="xbar")
    jop, pop = a.op(), p.op()
    assert jop.chain_ready and pop.chain_ready
    b = np.random.default_rng(4).standard_normal(N).astype(np.float32)
    return a, jop, pop, b


@pytest.fixture(scope="module")
def two_chunks(system):
    """Two chunks of 4 from x0 = 0 in both packages."""
    _, jop, pop, b = system
    jb = jnp.asarray(padded(b, jop.m_pad))
    jz = jop.inv_diag * jb
    want = jop.cg_chain(jnp.zeros_like(jb), jb, jz, jnp.vdot(jb, jz), 4)
    want = jop.cg_chain(*want[:4], 4)
    got = pop.cg_chain(*_start(pop, b), 4)
    got = pop.cg_chain(*got[:4], 4)
    return got, want


@pytest.mark.parametrize("i", range(5), ids=OUTPUTS)
def test_cg_chain_vs_jax(two_chunks, i):
    got, want = two_chunks
    if i < 3:
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i])[:N],
                                   **VEC_TOL)
    else:
        assert got[i].shape == () and got[i].dtype == torch.float32
        np.testing.assert_allclose(float(got[i]), float(want[i]), rtol=2e-4)
    if OUTPUTS[i] == "res2":
        r = got[1].double()
        np.testing.assert_allclose(float(got[4]), float(r @ r), rtol=1e-5)


def test_two_chains_of_4_equal_one_of_8(system):
    """Chunk continuation as solvers/cg.py uses it."""
    _, _, op, b = system
    state = _start(op, b)
    one = op.cg_chain(*state, 8)
    two = op.cg_chain(*op.cg_chain(*state, 4)[:4], 4)
    for g, w in zip(two, one):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **VEC_TOL)


def test_cg_chain_matches_explicit_pcg(system):
    _, _, op, b = system
    x, r, p, rz = _start(op, b)
    xc, rc, pc, rzc, res2 = op.cg_chain(x, r, p, rz, 7)
    for _ in range(7):
        q = op.matvec(p)
        alpha = rz / torch.dot(p, q)
        x = x + alpha * p
        r = r - alpha * q
        z = op.inv_diag * r
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    for g, w in ((xc, x), (rc, r), (pc, p)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **VEC_TOL)
    np.testing.assert_allclose(float(rzc), float(rz), rtol=2e-4)
    np.testing.assert_allclose(float(res2), float(torch.dot(r, r)),
                               rtol=2e-4)


def test_cg_chain_leaves_inputs_and_keeps_dtype(system):
    _, _, op, b = system
    state = [v.double() if v.dim() else v for v in _start(op, b)]
    copies = [v.clone() for v in state]
    out = op.cg_chain(*state, 3)
    assert [v.dtype for v in out[:3]] == [torch.float64] * 3
    for v, c in zip(state, copies):
        assert torch.equal(v, c)


def test_cg_chain_guards(system):
    """A non-square operator is not chain-ready; iters must be >= 1."""
    rng = np.random.default_rng(4)
    rows, cols = rng.integers(0, 40, 200), rng.integers(0, 60, 200)
    rect = K.pack_csr(CSR.from_coo(rows, cols, rng.uniform(-1, 1, 200),
                                   (40, 60)), device="cpu")
    with pytest.raises(ValueError, match="chain-ready"):
        rect.cg_chain(torch.zeros(60), torch.zeros(60), torch.zeros(60), 1.0, 2)
    _, _, op, b = system
    with pytest.raises(ValueError, match="iters"):
        op.cg_chain(*_start(op, b), 0)


# ------------------------------------------------------------------ solves

def _host_rel(a, x, b):
    return np.linalg.norm(a.csr.matvec(x) - b) / np.linalg.norm(b)


def _agree(a, b, rj, rp, slack, eps=1e-6):
    assert rj.converged and rp.converged
    assert rp.method == rj.method
    assert abs(rj.iterations - rp.iterations) <= slack
    np.testing.assert_allclose(rp.solution, rj.solution,
                               rtol=0, atol=1e-5 * np.abs(rj.solution).max())
    for r in (rj, rp):
        assert _host_rel(a, r.solution, b) <= eps, r


SOLVE_CASES = {
    # id: (option overrides, iteration slack, takes the chain path)
    "chain": (dict(check_every=5), 5, True),
    "per-step": (dict(check_every=1), 1, False),
    "relative-change": (dict(convergence_mode="relative_change"), 1, False),
}


@pytest.mark.parametrize("case", sorted(SOLVE_CASES))
def test_solve_cg_sparse_matches(case, monkeypatch):
    """n=500 SPD with prefer="xbar": the JAX package's crossbar CG against the
    port's CSR CG, on the chain path and on the per-step path."""
    opts, slack, chained = SOLVE_CASES[case]
    a, p = matrix_pair(*spd_coo(N, seed=8), (N, N), prefer="xbar")
    b = np.random.default_rng(5).standard_normal(N)
    chunks = []
    real = K.CsrOperator.cg_chain
    monkeypatch.setattr(K.CsrOperator, "cg_chain",
                        lambda self, *s: chunks.append(s[-1]) or real(self, *s))
    jopts, popts = dict(opts), dict(opts)
    if "convergence_mode" in opts:
        jopts["convergence_mode"] = JaxMode(opts["convergence_mode"])
        popts["convergence_mode"] = PortMode(opts["convergence_mode"])
    rj = slt.solve(a, b, method="cg", epsilon=1e-6, **jopts)
    rp = slp.solve(p, b, method="cg", epsilon=1e-6, **popts)
    _agree(a, b, rj, rp, slack)
    assert rp.method == "conjugate-gradient"
    assert bool(chunks) == chained
    if chained:  # head chunk of 2 * check_every, then tails of 2
        assert chunks[0] == 10 and set(chunks[1:]) <= {2}
        assert rp.iterations == sum(chunks)


def test_solve_cg_dense_matches():
    n = 300
    a, p = matrix_pair(*spd_coo(n, seed=9), (n, n))
    assert a._op_kind() == p._op_kind() == "dense"
    b = np.random.default_rng(6).standard_normal(n)
    rj = slt.solve(a, b, method="cg", epsilon=1e-6)
    rp = slp.solve(p, b, method="cg", epsilon=1e-6, collect_stats=True)
    _agree(a, b, rj, rp, 1)
    assert rp.stats.matvec_count == rp.iterations + 1


@pytest.mark.parametrize("route,prefer,n", [("sparse", "xbar", 600),
                                            ("dense", None, 300)])
def test_solve_bicgstab_matches(route, prefer, n):
    a, p = matrix_pair(*dd_coo(n, deg=5, seed=41), (n, n), prefer=prefer)
    assert {"sparse": "csr"}.get(route, route) == p._op_kind()
    assert not slp.analyze(p).is_symmetric
    b = np.random.default_rng(42).standard_normal(n)
    rj = slt.solve(a, b, method="bicgstab", epsilon=1e-6)
    rp = slp.solve(p, b, method="bicgstab", epsilon=1e-6)
    _agree(a, b, rj, rp, 1)


def test_cg_on_asymmetric_runs_bicgstab():
    n = 300
    a, p = matrix_pair(*dd_coo(n, deg=5, seed=43), (n, n))
    b = np.random.default_rng(44).standard_normal(n)
    rj = slt.solve(a, b, method="cg", epsilon=1e-6)
    rp = slp.solve(p, b, method="cg", epsilon=1e-6)
    assert rp.method == rj.method == "bicgstab"
    _agree(a, b, rj, rp, 1)


def test_adaptive_polishes_a_short_neumann_with_cg():
    """Weak dominance (strength just over 0.3, so adaptive picks Neumann)
    and a budget of 10 iterations: Neumann stops short, and CG finishes from
    its iterate."""
    n = 300
    rows, cols, vals = spd_coo(n, seed=12)
    diag = rows == cols
    off = np.zeros(n)
    np.add.at(off, rows[~diag], np.abs(vals[~diag]))
    vals = np.where(diag, 1.45 * off[rows] + 1e-3, vals)
    a, p = matrix_pair(rows, cols, vals, (n, n))
    b = np.random.default_rng(13).standard_normal(n)
    assert slp.select_method(p, b) == slp.Method.NEUMANN
    kw = dict(method="adaptive", epsilon=1e-6, max_iterations=10)
    rj = slt.solve(a, b, **kw)
    rp = slp.solve(p, b, **kw)
    assert rp.method == rj.method == "adaptive(neumann->conjugate-gradient)"
    assert slp.solve(p, b, method="neumann", epsilon=1e-6, max_iterations=10,
                     raise_on_fail=False).converged is False
    _agree(a, b, rj, rp, 1)


def test_timeout_path_runs_cg():
    p = slp.Matrix.from_coo(*spd_coo(N, seed=14), (N, N), device="cpu")
    b = np.random.default_rng(15).standard_normal(N)
    r = slp.solve(p, b, method="cg", epsilon=1e-6, timeout=60.0)
    assert r.converged and _host_rel(p, r.solution, b) <= 1e-6


def test_cpu_cg_solve_launches_no_kernel():
    _, p = matrix_pair(*spd_coo(N, seed=16), (N, N), prefer="xbar")
    before = dict(K.LAUNCHES)
    slp.solve(p, np.ones(N), method="cg", epsilon=1e-6)
    slp.solve(p, np.ones(N), method="bicgstab", epsilon=1e-6)
    assert K.LAUNCHES == before
