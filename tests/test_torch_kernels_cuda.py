"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips when no card is present (decided in the
fixture, not at import).  On a machine with a card and without jax, run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q

(``--noconftest`` because tests/conftest.py imports jax).  This file imports
only the port.  Tolerance: max |kernel - plain| <= 1e-5 * max |plain| (f32
sums taken in another order).
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


def test_wrapper_rejects_wrong_dtype(op, x):
    with pytest.raises(ValueError, match="float32"):
        K.csr_spmv(op, x.double())


def test_solve_on_card(op):
    a = slp.generate("random-sparse", 20_000, seed=7, density=5e-4)
    b = slp.rhs(20_000, seed=7)
    r = slp.solve(a, b, method="neumann", epsilon=1e-6)
    rel = np.linalg.norm(a.csr.matvec(r.solution) - b) / np.linalg.norm(b)
    assert r.converged and rel < 1e-5
