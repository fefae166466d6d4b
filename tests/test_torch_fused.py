"""The port's dense fused path (``ops/dense_fused.py``,
``solvers/fused.py``) against the JAX package's (``ops/pallas_kernels.py``,
``solvers/fused.py``).

The same inputs, made with numpy from seeds, go through both packages: the
JAX kernels in interpret mode, as tests/test_pallas.py runs them, and the
port's wrappers on CPU tensors, which take their plain PyTorch twins.  Both
are compared on the first n entries: the JAX operators pad each side to a
multiple of 128, the port's do not (n = 200 pads to 256 in JAX only).

Tolerances, on max |port - jax| / max |jax|: 1e-5 for the f32 kernels (f32
sums taken in another order); 1e-4 for bf16x3, whose bf16 split of t can
round the other way where the two f32 t's differ in the last bit.  Solves:
the same method and outcome, iterations within one block, solutions within
1e-5 (highest) and 1e-3 (bf16x3 at epsilon 1e-3) of max |x|.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sublinear_tpu as slt
from sublinear_tpu.graph.pagerank import _transition_matrix
from sublinear_tpu.ops import pallas_kernels as pk
from sublinear_tpu.solvers.fused import solve_neumann_fused as jax_fused
from sublinear_tpu_torch import interop
from sublinear_tpu_torch import types as ptypes
from sublinear_tpu_torch.ops import dense_fused as df
from sublinear_tpu_torch.solvers import fused as pfused

from torch_parity import port_on_cpu  # noqa: F401  (autouse)

torch.set_num_threads(2)

RTOL = 1e-5
RTOL_X3 = 1e-4
BLOCK = 8  # solve_neumann_fused's default block


def _port_matrix(a):
    return interop.matrix_from_reference(a.csr.indptr, a.csr.indices,
                                         a.csr.data, a.shape, device="cpu")


def _dense_pair(n, seed, density=0.1):
    """(JAX dense operator, port dense operator) of one seeded DD matrix."""
    a = slt.generate("random-sparse", n, seed=seed, density=density)
    jop, pop = a.op(), _port_matrix(a).op()
    assert type(jop).__name__ == type(pop).__name__ == "DenseOperator"
    return jop, pop


def _block(values, n_pad):
    """An (n, B) block for the port and the same, zero-padded to n_pad
    rows, for the JAX package."""
    out = np.zeros((n_pad, values.shape[1]), np.float32)
    out[: values.shape[0]] = values
    return torch.as_tensor(values.astype(np.float32)), jnp.asarray(out)


def _diag_cols(jop, pop):
    return ((pop.diag[:, None], pop.inv_diag[:, None]),
            (jop.diag[:, None], jop.inv_diag[:, None]))


def _close(got, want, rtol):
    n = got.shape[0]
    want = np.asarray(want, np.float64)[:n]
    err = np.abs(got.double().numpy() - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


CASES = [(n, B, iters) for n in (96, 200) for B in (1, 4) for iters in (8, 60)]
CASE_IDS = [f"n{n}-B{B}-T{t}" for n, B, t in CASES]


def _inputs(n, B, seed):
    jop, pop = _dense_pair(n, seed)
    rng = np.random.default_rng(seed)
    b, jb = _block(rng.standard_normal((n, B)), jop.n_pad)
    x0, jx0 = _block(0.1 * rng.standard_normal((n, B)), jop.n_pad)
    return jop, pop, (b, x0), (jb, jx0)


@pytest.mark.parametrize("n,B,iters", CASES, ids=CASE_IDS)
def test_dense_neumann_fused(n, B, iters):
    jop, pop, (b, x0), (jb, jx0) = _inputs(n, B, seed=1)
    (d, dinv), (jd, jdinv) = _diag_cols(jop, pop)
    got = df.dense_neumann_fused(pop.data, d, dinv, b, x0, iters=iters)
    want = pk.dense_neumann_fused(jop.data, jd, jdinv, jb, jx0, iters=iters)
    assert got.shape == (n, B) and got.dtype == torch.float32
    _close(got, want, RTOL)


@pytest.mark.parametrize("n,B,iters", CASES, ids=CASE_IDS)
def test_dense_neumann_fused_bf16x3(n, B, iters):
    jop, pop, (b, x0), (jb, jx0) = _inputs(n, B, seed=2)
    (d, dinv), (jd, jdinv) = _diag_cols(jop, pop)
    ah, al = df.split_bf16(pop.data)
    jah, jal = pk.split_bf16(jop.data)
    got = df.dense_neumann_fused_bf16x3(ah, al, d, dinv, b, x0, iters=iters)
    want = pk.dense_neumann_fused_bf16x3(jah, jal, jd, jdinv, jb, jx0,
                                         iters=iters)
    _close(got, want, RTOL_X3)


@pytest.mark.parametrize("kernel,n", [("dense_neumann_fused", 768),
                                      ("dense_neumann_fused_bf16x3", 1536)])
def test_dense_neumann_at_path_width(kernel, n):
    """Each Neumann variant at the width the fused path gives it
    (solve_neumann_fused: n=768 takes the f32 kernel, n=1536 the bf16x3
    one), B=1, T=8; no padding in either package at these n."""
    jop, pop, (b, x0), (jb, jx0) = _inputs(n, 1, seed=4)
    assert jop.n_pad == pop.n_pad == n
    (d, dinv), (jd, jdinv) = _diag_cols(jop, pop)
    if kernel == "dense_neumann_fused":
        got = df.dense_neumann_fused(pop.data, d, dinv, b, x0, iters=BLOCK)
        want = pk.dense_neumann_fused(jop.data, jd, jdinv, jb, jx0,
                                      iters=BLOCK)
        _close(got, want, RTOL)
        return
    ah, al = df.split_bf16(pop.data)
    jah, jal = pk.split_bf16(jop.data)
    got = df.dense_neumann_fused_bf16x3(ah, al, d, dinv, b, x0, iters=BLOCK)
    want = pk.dense_neumann_fused_bf16x3(jah, jal, jd, jdinv, jb, jx0,
                                         iters=BLOCK)
    _close(got, want, RTOL_X3)


@pytest.mark.parametrize("n,B,iters", CASES, ids=CASE_IDS)
def test_dense_jacobi_fused(n, B, iters):
    jop, pop, (b, x0), (jb, jx0) = _inputs(n, B, seed=3)
    (d, dinv), (jd, jdinv) = _diag_cols(jop, pop)
    got = df.dense_jacobi_fused(pop.data, d, dinv, b, x0, iters=iters)
    want = pk.dense_jacobi_fused(jop.data, jd, jdinv, jb, jx0, iters=iters)
    _close(got, want, RTOL)


def test_dense_neumann_fused_warm_restart():
    """tests/test_pallas.py's restart: 8 iterations, then 40 more from
    there, in each package; both land on the solution."""
    jop, pop, (b, _), (jb, _) = _inputs(96, 1, seed=3)
    (d, dinv), (jd, jdinv) = _diag_cols(jop, pop)
    x1 = df.dense_neumann_fused(pop.data, d, dinv, b, torch.zeros_like(b), 8)
    x2 = df.dense_neumann_fused(pop.data, d, dinv, b, x1, 40)
    j1 = pk.dense_neumann_fused(jop.data, jd, jdinv, jb, jnp.zeros_like(jb), 8)
    j2 = pk.dense_neumann_fused(jop.data, jd, jdinv, jb, j1, 40)
    _close(x1, j1, RTOL)
    _close(x2, j2, RTOL)
    x_ref = np.linalg.solve(pop.data.double().numpy(), b.double().numpy())
    np.testing.assert_allclose(x2.numpy(), x_ref, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("n", [48, 96, 200])
@pytest.mark.parametrize("B,iters", [(1, 8), (1, 60), (4, 8), (4, 60)])
def test_dense_power_fused(n, B, iters):
    """P^T from the JAX package's ``_transition_matrix`` of a seeded random
    graph with dangling nodes, as tests/test_pallas.py builds it."""
    rng = np.random.default_rng(4 + n)
    dense = (rng.random((n, n)) < 0.15).astype(float)
    np.fill_diagonal(dense, 0.0)
    dense[: n // 8] = 0.0  # some dangling nodes
    PT = _transition_matrix(slt.Matrix.from_dense(dense))
    jop, pop = PT.op(), _port_matrix(PT).op()
    v = rng.random((n, B)) + 0.5
    v /= v.sum(axis=0)
    dang = np.repeat((dense.sum(axis=1) == 0).astype(float)[:, None], B, 1)
    (pv, jv), (pd, jd) = _block(v, jop.n_pad), _block(dang, jop.n_pad)
    got = df.dense_power_fused(pop.data, pv, pd, 0.85, iters=iters)
    want = pk.dense_power_fused(jop.data, jv, jd, 0.85, iters=iters)
    _close(got, want, RTOL)


def test_split_bf16_bit_identical():
    rng = np.random.default_rng(5)
    a = (rng.standard_normal((64, 48))
         * 10.0 ** rng.uniform(-6, 6, (64, 48))).astype(np.float32)
    a[0, :4] = [0.0, -0.0, 1.0 + 2.0 ** -9, 3.0e38]
    hi, lo = df.split_bf16(torch.as_tensor(a))
    jhi, jlo = pk.split_bf16(jnp.asarray(a))
    assert hi.dtype == lo.dtype == torch.bfloat16
    for got, want in ((hi, jhi), (lo, jlo)):
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy().view(np.uint16),
            np.asarray(want).view(np.uint16))


SIZES = {700: "highest", 768: "highest", 769: "bf16x3", 1500: "bf16x3",
         1536: "bf16x3", 1537: None, 3000: None}


@pytest.mark.parametrize("n", sorted(SIZES))
def test_fused_supported_and_variant_match(n):
    """The JAX package tests its 128-padded sides against the VMEM limits;
    the port rounds its unpadded sides the same way."""
    jop, pop = _dense_pair(n, seed=5, density=0.002)
    assert df.fused_supported(pop) == pk.fused_supported(jop)
    want = SIZES[n]
    assert pk.fused_supported(jop) == (want is not None)
    if want is not None:
        jax_variant = ("highest" if jop.n_pad <= pk.FUSED_HIGHEST_MAX_NPAD
                       else "bf16x3")
        assert pfused._variant(pop) == jax_variant == want


@pytest.mark.parametrize("shape,supported", [((100, 120), True),
                                             ((100, 200), False),
                                             ((130, 120), False)])
def test_fused_supported_non_square(shape, supported):
    """100 x 120 pads to 128 x 128 in JAX: square there, so supported."""
    n, m = shape
    rng = np.random.default_rng(6)
    rows, cols = rng.integers(0, n, 300), rng.integers(0, m, 300)
    a = slt.Matrix.from_coo(rows, cols, rng.uniform(-1, 1, 300), shape)
    jop, pop = a.op(), _port_matrix(a).op()
    assert pk.fused_supported(jop) == df.fused_supported(pop) == supported


def test_fused_limits_read_at_call_time(monkeypatch):
    jop, pop = _dense_pair(96, seed=1)
    monkeypatch.setattr(df, "FUSED_HIGHEST_MAX_NPAD", 0)
    assert pfused._variant(pop) == "bf16x3"
    monkeypatch.setattr(df, "FUSED_MAX_NPAD", 0)
    assert not df.fused_supported(pop)


def _solve_both(a, b, **options):
    rj = jax_fused(a, b, slt.SolverOptions(**options), raise_on_fail=False)
    rp = pfused.solve_neumann_fused(_port_matrix(a), b,
                                    ptypes.SolverOptions(**options),
                                    raise_on_fail=False)
    return rj, rp


def _agree(rj, rp, method, atol_rel):
    assert rj.method == rp.method == method
    assert rj.converged and rp.converged
    assert abs(rj.iterations - rp.iterations) <= BLOCK
    np.testing.assert_allclose(rp.solution, rj.solution, rtol=0,
                               atol=atol_rel * np.abs(rj.solution).max())


def test_solve_neumann_fused_highest():
    a = slt.generate("random-sparse", 200, seed=9, density=0.05)
    b = slt.rhs(200, seed=9)
    rj, rp = _solve_both(a, b, epsilon=1e-6)
    _agree(rj, rp, "neumann-fused-highest", 1e-5)
    assert rp.iterations % BLOCK == 0
    assert rp.stats is None or rp.stats.matvec_count == rp.iterations


def test_solve_neumann_fused_bf16x3_and_fallback(monkeypatch):
    """The bf16x3 variant, forced by dropping the HIGHEST cutoff in both
    packages; at 1e-6 both route to the full-f32 Neumann solver."""
    monkeypatch.setattr(pk, "FUSED_HIGHEST_MAX_NPAD", 0)
    monkeypatch.setattr(df, "FUSED_HIGHEST_MAX_NPAD", 0)
    a = slt.generate("random-sparse", 200, seed=9, density=0.05)
    b = slt.rhs(200, seed=9)
    rj, rp = _solve_both(a, b, epsilon=1e-3)
    _agree(rj, rp, "neumann-fused-bf16x3", 1e-3)
    rj, rp = _solve_both(a, b, epsilon=1e-6)
    assert rj.method == rp.method == "neumann"
    assert rj.converged and rp.converged


def test_solve_neumann_fused_unsupported_falls_back():
    a = slt.generate("random-sparse", 3000, seed=5, density=0.001)
    b = slt.rhs(3000, seed=5)
    rj, rp = _solve_both(a, b, epsilon=1e-6)
    assert rj.method == rp.method == "neumann"
    assert rj.converged and rp.converged


def test_solve_neumann_fused_non_square():
    """A 100 x 120 system runs the fused path in both packages (square once
    padded); the port pads it to 120 x 120, JAX to 128 x 128."""
    n, m = 100, 120
    rng = np.random.default_rng(7)
    rows, cols = rng.integers(0, n, 600), rng.integers(0, m, 600)
    vals = rng.uniform(-1, 1, 600)
    diag = np.zeros(n)
    np.add.at(diag, rows, np.abs(vals))
    a = slt.Matrix.from_coo(np.r_[rows, np.arange(n)], np.r_[cols, np.arange(n)],
                            np.r_[vals, 1.5 * diag + 1.0], (n, m))
    b = np.random.default_rng(8).standard_normal(n)
    rj, rp = _solve_both(a, b, epsilon=1e-6)
    _agree(rj, rp, "neumann-fused-highest", 1e-5)


def test_solve_neumann_fused_warm_start_and_no_launch():
    """x0 carries over as in the JAX package; on the CPU no kernel runs."""
    a = slt.generate("random-sparse", 200, seed=9, density=0.05)
    b = slt.rhs(200, seed=9)
    x0 = 0.5 * np.linalg.solve(a.to_dense(), b)
    before = dict(df.LAUNCHES)
    rj, rp = _solve_both(a, b, epsilon=1e-6, x0=x0)
    assert df.LAUNCHES == before
    _agree(rj, rp, "neumann-fused-highest", 1e-5)
