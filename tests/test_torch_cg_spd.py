"""The SPD form of the headline system under ``solve(method="cg")``, held to
a plain float64 reference (``torch.linalg.solve`` on the dense matrix).

The matrix is the benchmark's own ``random-sparse-spd`` kind
(``bench_port/kinds/random-sparse-spd.py``) at n = 2,000 with ~10
off-diagonal entries a row, on the ``"csr"`` route so that CG takes its
chain path (``cg_chain``'s plain version on the CPU).  Plain torch only:
this module imports neither JAX nor the JAX package.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import sublinear_tpu_torch as slp
from sublinear_tpu_torch import tracing
from bench_port import gen, lookup

N, DENSITY, EPS = 2000, 5e-3, 1e-6
CFG = {"n": N, "density": DENSITY, "diag_scale": 1.5, "diag_shift": 1.0}
# The error a residual at EPS leaves is about kappa * EPS, kappa the
# condition number of D^-1/2 A D^-1/2, the Jacobi-scaled matrix that the
# preconditioned CG works on: under 5 by Gershgorin (each row's off-diagonal
# |sum| is under 2/3 of its diagonal), about 2 measured (asserted below).
# 1e-5 = 10 EPS leaves room; a bfloat16 solve misses it by far.
ERR_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def port_on_cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SLT_TORCH_DEVICE", "cpu")
        yield


def _data(seed=2**33 + 17, kind="random-sparse-spd"):
    g = gen.generator(seed, "cpu")
    make = (gen.random_sparse if kind == "random-sparse"
            else lookup.load(lookup.KINDS_DIR, kind).make)
    return make(CFG, g, "cpu"), g


def _dense(d) -> torch.Tensor:
    A = torch.zeros(d.n, d.n, dtype=torch.float64)
    A.index_put_((torch.from_numpy(d.rows), torch.from_numpy(d.cols)),
                 torch.from_numpy(d.vals), accumulate=True)
    return A


@pytest.fixture(scope="module")
def spd():
    d, g = _data()
    A = slp.Matrix.from_coo(d.rows, d.cols, d.vals, (N, N), prefer="csr")
    B = gen.uniform_block((4, N), g, "cpu")
    return d, A, _dense(d), B


def _plain_cg(A: torch.Tensor, b: torch.Tensor, iterations: int) -> torch.Tensor:
    """Jacobi-preconditioned CG in A's dtype, a fixed number of steps."""
    inv_d = 1.0 / torch.diagonal(A)
    x = torch.zeros_like(b)
    r = b.clone()
    z = inv_d * r
    p, rz = z, torch.dot(r, z)
    for _ in range(iterations):
        q = A @ p
        alpha = rz / torch.dot(p, q)
        x = x + alpha * p
        r = r - alpha * q
        z = inv_d * r
        rz_new = torch.dot(r, z)
        p = z + rz_new / rz * p
        rz = rz_new
    return x


def _errors(A64, x, b):
    """(||A x - b||_2 / ||b||_2, ||x - x*||_inf / ||x*||_inf), float64."""
    x = torch.as_tensor(np.asarray(x), dtype=torch.float64)
    b = torch.as_tensor(np.asarray(b), dtype=torch.float64)
    x_star = torch.linalg.solve(A64, b)
    res = torch.linalg.vector_norm(A64 @ x - b) / torch.linalg.vector_norm(b)
    err = (x - x_star).abs().max() / x_star.abs().max()
    return float(res), float(err)


def test_the_kind_is_exactly_symmetric_and_strictly_dominant(spd):
    d, A, A64, _ = spd
    assert round(DENSITY * N * (N - 1) / 2) == 9995
    assert d.rows.size == 2 * 9995 + N  # mirrored positions and the diagonal
    assert torch.equal(A64, A64.T)
    diag = torch.diagonal(A64)
    off = A64.abs().sum(dim=1) - diag.abs()
    assert bool((diag > 0).all()) and bool((diag > off).all())
    assert slp.analyze(A, estimate_condition=False).is_symmetric
    s = diag.rsqrt()
    ev = torch.linalg.eigvalsh(s[:, None] * A64 * s[None, :])
    assert float(ev[0]) > 0 and float(ev[-1] / ev[0]) < 5.0  # see ERR_TOL


@pytest.mark.parametrize("column", range(4))
def test_cg_chain_solve_matches_the_float64_reference(spd, column):
    _, A, A64, B = spd
    b = B[column]
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        r = slp.solve(A, b, method="cg", epsilon=EPS)
    counts = tracing.counters()
    tracing.reset()
    assert r.method == "conjugate-gradient" and r.converged
    assert counts["cg_chain_calls"] >= 1
    res, err = _errors(A64, r.solution, b)
    assert res <= EPS, res
    assert err <= ERR_TOL, err


def test_a_bfloat16_solve_fails_both_tolerances(spd):
    _, _, A64, B = spd
    b = torch.from_numpy(B[0])
    # the plain CG in bfloat16: it stalls at bfloat16's level within 10 steps
    x = _plain_cg(A64.to(torch.bfloat16), b.to(torch.bfloat16), 20)
    res, err = _errors(A64, x.double().numpy(), b)
    assert res > EPS and err > ERR_TOL, (res, err)


def test_an_asymmetric_matrix_of_the_headline_recipe_goes_to_bicgstab():
    d, g = _data(kind="random-sparse")
    A = slp.Matrix.from_coo(d.rows, d.cols, d.vals, (N, N), prefer="csr")
    assert not slp.analyze(A, estimate_condition=False).is_symmetric
    b = gen.uniform_block((N,), g, "cpu")
    r = slp.solve(A, b, method="cg", epsilon=EPS)
    assert r.method == "bicgstab" and r.converged
    res, _ = _errors(_dense(d), r.solution, b)
    assert res <= EPS, res
