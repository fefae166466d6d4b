"""Shared inputs for the port's parity tests (tests/test_torch_*.py).

Both packages get the same state: a matrix made with numpy from a seed is
built as a JAX-package ``Matrix`` and carried into the port with
``interop.matrix_from_reference`` on the CPU, where the port's wrappers run
their kernels' plain PyTorch versions.
"""
import numpy as np
import torch

from sublinear_tpu.matrix import Matrix as JaxMatrix
from sublinear_tpu_torch import interop


def dd_coo(n, deg=5, seed=0):
    """Random row-diagonally-dominant COO triplets, ~deg entries per row."""
    rng = np.random.default_rng(seed)
    cnt = n * deg
    r = rng.integers(0, n, cnt)
    c = rng.integers(0, n, cnt)
    v = rng.uniform(-1, 1, cnt)
    _, ui = np.unique(r.astype(np.int64) * n + c, return_index=True)
    r, c, v = r[ui], c[ui], v[ui]
    off = r != c
    r, c, v = r[off], c[off], v[off]
    diag = np.zeros(n)
    np.add.at(diag, r, np.abs(v))
    return (np.r_[r, np.arange(n)], np.r_[c, np.arange(n)],
            np.r_[v, diag * 1.5 + 1.0])


def spd_coo(n, seed=3):
    """Symmetric, strictly diagonally dominant (so SPD) COO triplets: the
    construction of tests/test_xbar.py's CG tests (~10 entries per row)."""
    rng = np.random.default_rng(seed)
    cnt = n * 5
    r = rng.integers(0, n, cnt)
    c = rng.integers(0, n, cnt)
    v = rng.uniform(-1, 1, cnt)
    off = r != c
    r, c, v = r[off], c[off], v[off]
    rows, cols, vals = np.r_[r, c], np.r_[c, r], np.r_[v, v]
    diag = np.zeros(n)
    np.add.at(diag, rows, np.abs(vals))
    return (np.r_[rows, np.arange(n)], np.r_[cols, np.arange(n)],
            np.r_[vals, diag * 1.2 + 1.0])


def banded_coo(n, seed=0, band=3):
    """The JAX package's "banded" catalog recipe (generate.py::catalog_matrix)
    from a numpy seed: bands +-1..+-band with U(-1, 1) weights, mirrored,
    diagonal 1.2 * |row sum| + 1.  Symmetric and strictly DD."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for off in range(1, band + 1):
        idx = np.arange(n - off)
        w = rng.uniform(-1, 1, size=n - off)
        rows += [idx, idx + off]
        cols += [idx + off, idx]
        vals += [w, w]
    rows, cols, vals = map(np.concatenate, (rows, cols, vals))
    s = np.zeros(n)
    np.add.at(s, rows, np.abs(vals))
    d = np.arange(n)
    return np.r_[rows, d], np.r_[cols, d], np.r_[vals, 1.2 * s + 1.0]


def matrix_pair(rows, cols, vals, shape, prefer=None):
    """(JAX-package Matrix, port Matrix on the CPU) over the same CSR."""
    a = JaxMatrix.from_coo(rows, cols, vals, shape, prefer=prefer)
    p = interop.matrix_from_reference(a.csr.indptr, a.csr.indices, a.csr.data,
                                      a.shape, device="cpu", prefer=prefer)
    return a, p


def padded(v, length):
    """float32 numpy vector of ``length`` with ``v`` at the front (the JAX
    operators pad their domains, the port's do not)."""
    out = np.zeros(length, np.float32)
    out[: v.size] = v
    return out


def t32(v):
    return torch.as_tensor(np.asarray(v, np.float32))
