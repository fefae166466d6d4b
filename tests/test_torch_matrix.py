"""The host methods of the port's ``Matrix`` against the JAX package's:
``matvec``, ``to_dense``, ``to_dict`` (both formats), ``transpose``,
``diagonal_vector`` and ``reorder_rcm``.  They are NumPy over the same CSR,
so they must be bit-identical (the RCM permutation too: the port copies the
JAX package's NumPy search, which its native C++ version matches)."""
import numpy as np
import pytest
import torch

import sublinear_tpu as slt
import sublinear_tpu_torch as slp
from sublinear_tpu.errors import SolverError as JaxSolverError
from sublinear_tpu_torch.errors import SolverError as PortSolverError

from torch_parity import banded_coo, dd_coo, matrix_pair, port_on_cpu

torch.set_num_threads(2)


def _rectangular():
    rng = np.random.default_rng(5)
    rows, cols = rng.integers(0, 40, 150), rng.integers(0, 70, 150)
    return rows, cols, rng.uniform(-1, 1, 150), (40, 70)


def _components():
    """Two banded blocks and isolated nodes: several RCM components with
    ties in degree."""
    r1, c1, v1 = banded_coo(50, seed=3, band=2)
    r2, c2, v2 = banded_coo(30, seed=4, band=1)
    iso = np.arange(80, 90)
    return (np.r_[r1, r2 + 50, iso], np.r_[c1, c2 + 50, iso],
            np.r_[v1, v2, np.ones(10)], (90, 90))


SYSTEMS = {
    "random-dd": lambda: (*dd_coo(500, deg=4, seed=11), (500, 500)),
    "banded": lambda: (*banded_coo(400, seed=12), (400, 400)),
    "components": _components,
    "rectangular": _rectangular,
}


@pytest.fixture(params=sorted(SYSTEMS))
def pair(request):
    return matrix_pair(*SYSTEMS[request.param]())


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_matvec_to_dense_diagonal(pair):
    a, p = pair
    x = np.random.default_rng(0).standard_normal(a.shape[1])
    _equal(p.matvec(x), a.matvec(x))
    _equal(p.to_dense(), a.to_dense())
    _equal(p.diagonal_vector(), a.diagonal_vector())


@pytest.mark.parametrize("fmt", ["coo", "dense"])
def test_to_dict(pair, fmt):
    a, p = pair
    assert p.to_dict(fmt) == a.to_dict(fmt)
    back = slp.Matrix.from_dict(p.to_dict(fmt), device="cpu")
    _equal(back.to_dense(), a.to_dense())


def test_transpose(pair):
    a, p = pair
    ta, tp = a.transpose(), p.transpose()
    assert tp.shape == ta.shape
    for name in ("indptr", "indices", "data"):
        _equal(getattr(tp.csr, name), getattr(ta.csr, name))
    assert tp.device == p.device


def test_transpose_keeps_prefer():
    _, p = matrix_pair(*dd_coo(300, deg=4, seed=13), (300, 300),
                       prefer="xbar")
    assert p.transpose()._op_kind() == "csr"
    assert p.transpose().device.type == "cpu"


def test_reorder_rcm(pair):
    a, p = pair
    if not a.is_square():
        for pkg, m, err in ((slt, a, JaxSolverError), (slp, p, PortSolverError)):
            with pytest.raises(err) as exc:
                m.reorder_rcm()
            assert type(exc.value).__name__ == "InvalidMatrixError"
        return
    (ba, perm_a), (bp, perm_p) = a.reorder_rcm(), p.reorder_rcm()
    _equal(perm_p, perm_a)
    for name in ("indptr", "indices", "data"):
        _equal(getattr(bp.csr, name), getattr(ba.csr, name))
    assert bp.device == p.device
    dense = a.to_dense()
    _equal(bp.to_dense(), dense[np.ix_(perm_a, perm_a)])
