"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips when no card is present (decided in the
fixture, not at import).  On a machine with a card and without jax, run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q

(``--noconftest`` because tests/conftest.py imports jax).  This file imports
only the port.  Tolerance: max |kernel - plain| <= 1e-5 * max |plain| (f32
sums taken in another order), 1e-4 for the CG chain.
"""
import numpy as np
import pytest
import torch

import sublinear_tpu_torch as slp
from sublinear_tpu_torch.ops import csr_spmv as K

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda

RTOL = 1e-5


@pytest.fixture(scope="module")
def op():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = slp.generate("random-sparse", 20_000, seed=7, density=5e-4)
    assert a._op_kind() == "csr"
    return a.op()


@pytest.fixture(scope="module")
def x(op):
    rng = np.random.default_rng(1)
    return torch.as_tensor(rng.uniform(-1, 1, op.n_pad), dtype=torch.float32,
                           device=op.device)


def _close(got, want):
    got, want = got.double().reshape(-1), want.double().reshape(-1)
    assert float((got - want).abs().max()) <= RTOL * float(want.abs().max())


@pytest.mark.parametrize("with_diag", [True, False])
def test_csr_spmv(op, x, with_diag):
    diag = op.diag if with_diag else None
    before = K.LAUNCHES["csr_spmv"]
    got = K.csr_spmv(op, x, diag)
    assert K.LAUNCHES["csr_spmv"] == before + 1
    _close(got, K.csr_spmv_plain(op, x, diag))


@pytest.mark.parametrize("with_residual", [False, True, "norm"])
def test_neumann_chain(op, x, with_residual):
    before = K.LAUNCHES["neumann_step"]
    got = K.neumann_chain(op, x, 7, with_residual)
    assert K.LAUNCHES["neumann_step"] == before + 7
    want = K.neumann_chain_plain(op, x, 7, with_residual)
    for g, w in zip(got, want):
        _close(g, w)


def test_cg_chain(op, x):
    """The CG kernel's state against the plain chain, and its launch count
    (one per CG step).  op is asymmetric, which the recurrence does not
    mind; the tolerance is 1e-4 * max|plain|, as f32 CG steps amplify the
    differences of summation order."""
    r = x.clone()
    z = op.inv_diag * r
    rz = K.dot64(r, z)
    before = K.LAUNCHES["cg_step"]
    got = K.cg_chain(op, torch.zeros_like(x), r, z, rz, 6)
    assert K.LAUNCHES["cg_step"] == before + 6
    want = K.cg_chain_plain(op, torch.zeros_like(x), r, z, rz, 6)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        g, w = g.double().reshape(-1), w.double().reshape(-1)
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


def test_wrapper_rejects_wrong_dtype(op, x):
    with pytest.raises(ValueError, match="float32"):
        K.csr_spmv(op, x.double())


def test_solve_on_card(op):
    a = slp.generate("random-sparse", 20_000, seed=7, density=5e-4)
    b = slp.rhs(20_000, seed=7)
    r = slp.solve(a, b, method="neumann", epsilon=1e-6)
    rel = np.linalg.norm(a.csr.matvec(r.solution) - b) / np.linalg.norm(b)
    assert r.converged and rel < 1e-5


def test_cg_solve_on_card():
    """solve(method="cg") on a symmetric matrix takes the chain path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = slp.generate("random-sparse", 20_000, seed=7, density=5e-4)
    rows, cols, vals = a.csr.to_coo()
    up = rows < cols
    rows, cols, vals = (np.r_[rows[up], cols[up]], np.r_[cols[up], rows[up]],
                        np.r_[vals[up], vals[up]])
    diag = np.zeros(20_000)
    np.add.at(diag, rows, np.abs(vals))
    d = np.arange(20_000)
    spd = slp.Matrix.from_coo(np.r_[rows, d], np.r_[cols, d],
                              np.r_[vals, 1.5 * diag + 1.0], (20_000, 20_000))
    b = slp.rhs(20_000, seed=7)
    before = K.LAUNCHES["cg_step"]
    r = slp.solve(spd, b, method="cg", epsilon=1e-6)
    rel = np.linalg.norm(spd.csr.matvec(r.solution) - b) / np.linalg.norm(b)
    assert r.converged and rel < 1e-5 and r.method == "conjugate-gradient"
    assert K.LAUNCHES["cg_step"] > before
