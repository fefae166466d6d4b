"""The port's DIA and ELL operators against the JAX package's
(``formats/dia.py::DiaOperator``, ``formats/ell.py::EllOperator``, plain
``jnp`` in both packages), the router's choice of them, their E007 byte
estimates, and CG solves on both routes.

Tolerances: DIA products rtol 1e-6 (the same shifted multiply-adds in the
same order); ELL products rtol 1e-5 with atol 1e-6 * max|y| (f32 sums over
the slots and the tail taken in another order); ``choose_slot_cap``
bit-identical (host NumPy copied); solves as in tests/test_torch_cg.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sublinear_tpu as slt
import sublinear_tpu_torch as slp
from sublinear_tpu.formats import ell as jell
from sublinear_tpu_torch.errors import SolverError as PortSolverError
from sublinear_tpu_torch.formats import ell as pell
from sublinear_tpu_torch.formats.streaming import estimate_op_bytes

from torch_parity import (banded_coo, dd_coo, matrix_pair, padded,
                          port_on_cpu, spd_coo, t32)

torch.set_num_threads(2)

N = 600
B = 3


def _rhs(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n).astype(np.float32),
            rng.standard_normal((n, B)).astype(np.float32))


def _padded_rows(X, length):
    out = np.zeros((length, X.shape[1]), np.float32)
    out[: X.shape[0]] = X
    return out


def _op_bytes(op):
    return sum(t.numel() * t.element_size() for t in vars(op).values()
               if isinstance(t, torch.Tensor))


# ------------------------------------------------------------------ DIA

@pytest.fixture(scope="module")
def banded():
    a, p = matrix_pair(*banded_coo(N, seed=1), (N, N))
    assert a._op_kind() == p._op_kind() == "dia"
    return a, p, a.op(), p.op()


def test_dia_layout(banded):
    _, _, jop, pop = banded
    assert type(pop).__name__ == "DiaOperator"
    assert pop.offsets == jop.offsets == (-3, -2, -1, 0, 1, 2, 3)
    assert pop.n_pad == pop.m_pad == N and pop.nnz == jop.nnz
    np.testing.assert_array_equal(pop.data.numpy(), np.asarray(jop.data)[:, :N])
    np.testing.assert_array_equal(pop.inv_diag.numpy(),
                                  np.asarray(jop.inv_diag)[:N])


@pytest.mark.parametrize("product", ["matvec", "matmat", "offdiag_matvec"])
def test_dia_products_vs_jax(banded, product):
    _, _, jop, pop = banded
    x, X = _rhs(N, 2)
    if product == "matmat":
        want = np.asarray(jop.matmat(jnp.asarray(_padded_rows(X, jop.m_pad))))
        got = pop.matmat(t32(X)).numpy()
    else:
        want = np.asarray(getattr(jop, product)(jnp.asarray(padded(x, jop.m_pad))))
        got = getattr(pop, product)(t32(x)).numpy()
    np.testing.assert_allclose(got, want[:N], rtol=1e-6)


def test_dia_cg_solve_matches(banded):
    a, p, _, _ = banded
    b = np.random.default_rng(3).standard_normal(N)
    rj = slt.solve(a, b, method="cg", epsilon=1e-6)
    rp = slp.solve(p, b, method="cg", epsilon=1e-6)
    _agree(a, b, rj, rp)


# ------------------------------------------------------------------ ELL

@pytest.fixture(scope="module")
def sparse():
    rows, cols, vals = dd_coo(N, deg=5, seed=51)
    a, p = matrix_pair(rows, cols, vals, (N, N), prefer="ell")
    return a, p


@pytest.mark.parametrize("slot_cap", [None, 2, "max"])
@pytest.mark.parametrize("product", ["matvec", "matmat", "offdiag_matvec"])
def test_ell_products_vs_jax(sparse, slot_cap, product):
    a, p = sparse
    if slot_cap == "max":
        slot_cap = int(a.csr.row_nnz().max())
    jop = jell.ell_from_csr(a.csr, slot_cap=slot_cap)
    pop = pell.ell_from_csr(p.csr, device="cpu", slot_cap=slot_cap)
    assert pop.slot_count == jop.slot_count and pop.tail_nnz == jop.tail_nnz
    assert (pop.tail_nnz == 0) == (slot_cap is not None and slot_cap > 2)
    x, X = _rhs(N, 52)
    if product == "matmat":
        want = np.asarray(jop.matmat(jnp.asarray(_padded_rows(X, jop.m_pad))))
        got = pop.matmat(t32(X)).numpy()
    else:
        want = np.asarray(getattr(jop, product)(jnp.asarray(padded(x, jop.m_pad))))
        got = getattr(pop, product)(t32(x)).numpy()
    want = want[:N]
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


DEGREES = {
    "poisson": lambda rng: rng.poisson(9, 5000),
    "power-law": lambda rng: np.minimum(rng.zipf(1.8, 5000), 4000),
    "constant": lambda rng: np.full(300, 7),
    "ones": lambda rng: np.ones(50, np.int64),
    "empty": lambda rng: np.zeros(0, np.int64),
}


@pytest.mark.parametrize("kind", sorted(DEGREES))
def test_choose_slot_cap_bit_identical(kind):
    row_nnz = DEGREES[kind](np.random.default_rng(61))
    assert pell.choose_slot_cap(row_nnz) == jell.choose_slot_cap(row_nnz)


def test_ell_cg_solve_matches():
    a, p = matrix_pair(*spd_coo(N, seed=62), (N, N), prefer="ell")
    assert type(p.op()).__name__ == "EllOperator"
    b = np.random.default_rng(63).standard_normal(N)
    rj = slt.solve(a, b, method="cg", epsilon=1e-6)
    rp = slp.solve(p, b, method="cg", epsilon=1e-6)
    _agree(a, b, rj, rp)


def test_ell_routes():
    """ELL where both packages take it: a dense-ish matrix above the dense
    size, single-RHS and batched.  The batch path of a large sparse matrix
    is ELL in the JAX package and "csr" in the port, whose CSR operator has
    a batched product (matrix.py's docstring)."""
    for n, density, batch in ((10_300, 0.021, False), (10_300, 0.021, True)):
        a = slt.generate("random-sparse", n, seed=5, density=density)
        p = slp.Matrix(a.csr, device="cpu")
        assert a._op_kind(batch=batch) == p._op_kind(batch=batch) == "ell"
    a = slt.generate("random-sparse", 11_000, seed=5, density=1e-3)
    p = slp.Matrix(a.csr, device="cpu")
    assert a._op_kind(batch=True) == "ell"
    assert p._op_kind(batch=True) == "csr"


# ------------------------------------------------------------------ E007

@pytest.mark.parametrize("kind", ["dia", "ell"])
def test_estimate_is_the_packed_size(kind):
    coo = banded_coo(N, seed=7) if kind == "dia" else dd_coo(N, deg=5, seed=8)
    p = slp.Matrix.from_coo(*coo, (N, N), prefer=kind, device="cpu")
    assert estimate_op_bytes(p.csr, kind) == _op_bytes(p.op())


@pytest.mark.parametrize("kind", ["dia", "ell"])
def test_memory_budget_raises_e007_before_packing(kind, monkeypatch):
    coo = banded_coo(N, seed=7) if kind == "dia" else dd_coo(N, deg=5, seed=8)
    p = slp.Matrix.from_coo(*coo, (N, N), prefer=kind, device="cpu")
    monkeypatch.setenv("SLT_MEMORY_LIMIT_BYTES",
                       str(estimate_op_bytes(p.csr, kind) - 1))
    with pytest.raises(PortSolverError) as exc:
        p.op()
    assert exc.value.code == "E007" and not p._ops


def _agree(a, b, rj, rp, eps=1e-6):
    assert rj.converged and rp.converged and rp.method == rj.method
    assert abs(rj.iterations - rp.iterations) <= 1
    np.testing.assert_allclose(rp.solution, rj.solution,
                               rtol=0, atol=1e-5 * np.abs(rj.solution).max())
    for r in (rj, rp):
        rel = np.linalg.norm(a.csr.matvec(r.solution) - b) / np.linalg.norm(b)
        assert rel <= eps, rel
