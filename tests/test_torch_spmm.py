"""The port's tiled one-hot SpMM (ops/tiled_spmm.py) and the batched CSR
product (CsrOperator.matmat, ops/csr_spmv.py) against the JAX package.

Both packages get the same numpy-seeded inputs; on the CPU the port's
``csr_spmm`` wrapper runs its plain PyTorch version, and the JAX
``onehot_spmm`` runs its Pallas kernel in interpret mode.  The cases are
those of tests/test_onehot_spmm.py.  Tolerances: ``build_tiles`` arrays bit
for bit; ``onehot_spmm`` within 2e-6 * max |Y| for both ``precise`` values
(the same per-entry bf16 arithmetic, the row sums taken in another order);
``matmat`` within 1e-5 * max |Y| of the ELL product and the host f64 CSR
(f32 sums in another order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sublinear_tpu as slt
from sublinear_tpu.ops import pallas_spmv as J
from sublinear_tpu_torch import interop
from sublinear_tpu_torch.formats.csr import CSR
from sublinear_tpu_torch.formats.ell import ell_from_csr
from sublinear_tpu_torch.ops import csr_spmv as K
from sublinear_tpu_torch.ops import tiled_spmm as TS

from torch_parity import dd_coo, matrix_pair, port_on_cpu

torch.set_num_threads(2)

RTOL = 2e-6
FIELDS = ("vals", "lrow", "lcol", "tile_rb", "tile_cb", "tile_first")


def _hub():
    """One dense row: multi-tile blocks (test_onehot_spmm_hub_rows)."""
    n = 300
    rows = [5] * 250 + list(range(n))
    cols = list(range(250)) + list(range(n))
    vals = [0.01] * 250 + [3.0] * n
    return (slt.Matrix.from_coo(rows, cols, vals, (n, n)),
            dict(R=128, C=128, T=64))


CASES = {
    "n600": lambda: (slt.generate("random-sparse", 600, seed=1,
                                  density=0.01), dict(R=256, C=256, T=128)),
    "hub": _hub,
    "fill": lambda: (slt.generate("random-sparse", 600, seed=2,
                                  density=0.05), dict(R=256, C=256, T=128)),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    a, sizes = CASES[request.param]()
    jt = J.build_tiles(a.csr, **sizes)
    pt = TS.build_tiles(a.csr, **sizes)
    rng = np.random.default_rng(0)
    X = np.zeros((jt.m_pad, 8), np.float32)
    X[: a.shape[1]] = rng.standard_normal((a.shape[1], 8))
    return a, jt, pt, X


def test_build_tiles_bit_identical(case):
    a, jt, pt, _ = case
    for name in FIELDS:
        want, got = np.asarray(getattr(jt, name)), getattr(pt, name).numpy()
        assert want.dtype == got.dtype and want.shape == got.shape, name
        np.testing.assert_array_equal(want, got, err_msg=name)
    assert (pt.n_pad, pt.m_pad, pt.shape) == (jt.n_pad, jt.m_pad, jt.shape)
    assert (pt.R, pt.C, pt.T, pt.n_tiles) == (jt.R, jt.C, jt.T, jt.n_tiles)
    assert pt.fill == jt.fill


def test_csr_view_holds_the_input_entries(case):
    a, _, pt, _ = case
    n = a.shape[0]
    view = pt.csr
    assert view.shape == (pt.n_pad, pt.m_pad) and not view.diag_split
    np.testing.assert_array_equal(view.indptr.numpy()[: n + 1], a.csr.indptr)
    assert np.all(view.indptr.numpy()[n:] == a.csr.nnz)
    np.testing.assert_array_equal(view.indices.numpy(), a.csr.indices)
    np.testing.assert_array_equal(view.vals.numpy(),
                                  a.csr.data.astype(np.float32))


def test_csr_view_keeps_explicit_zeros():
    csr = CSR(np.array([0, 2, 3, 3]), np.array([0, 2, 1]),
              np.array([1.5, 0.0, -2.0]), (3, 3))
    pt = TS.build_tiles(csr, R=128, C=128, T=128)
    assert pt.csr.nnz == 3
    np.testing.assert_array_equal(pt.csr.vals.numpy(), [1.5, 0.0, -2.0])
    X = torch.arange(128 * 2, dtype=torch.float32).reshape(128, 2)
    Y = TS.onehot_spmm(pt, X)
    assert Y.shape == (128, 2)
    np.testing.assert_array_equal(Y[:3].numpy(),
                                  [[0.0, 1.5], [-4.0, -6.0], [0.0, 0.0]])


@pytest.mark.parametrize("precise", [True, False])
def test_onehot_spmm_matches_jax(case, precise):
    _, jt, pt, X = case
    want = np.asarray(J.onehot_spmm(jt, jnp.asarray(X), precise=precise))
    got = TS.onehot_spmm(pt, torch.as_tensor(X), precise=precise).numpy()
    assert got.shape == want.shape == (jt.n_pad, 8)
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


@pytest.mark.parametrize("precise", [True, False])
def test_tiles_from_reference(case, precise):
    """JAX's tiles carried into the port give the same arrays, the same CSR
    view (no explicit zeros here) and the same product."""
    _, jt, pt, X = case
    rt = interop.tiles_from_reference(
        *(np.asarray(getattr(jt, f)) for f in FIELDS), n_pad=jt.n_pad,
        m_pad=jt.m_pad, shape=jt.shape, R=jt.R, C=jt.C, T=jt.T)
    for name in FIELDS:
        assert torch.equal(getattr(rt, name), getattr(pt, name)), name
    for name in ("indptr", "indices", "vals"):
        assert torch.equal(getattr(rt.csr, name), getattr(pt.csr, name)), name
    want = np.asarray(J.onehot_spmm(jt, jnp.asarray(X), precise=precise))
    got = TS.onehot_spmm(rt, torch.as_tensor(X), precise=precise).numpy()
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


def test_precise_beats_bf16():
    """Against the f64 product: precise=True keeps about 16 bits of each
    entry's product (ph + plo, with vl*xl dropped), so it lands within
    3e-5 * max |Y|; precise=False rounds each product to bf16's 8 bits,
    within 2e-2 * max |Y| (test_onehot_spmm.py's bound)."""
    a = slt.generate("random-sparse", 600, seed=1, density=0.01)
    pt = TS.build_tiles(a.csr, R=256, C=256, T=128)
    rng = np.random.default_rng(3)
    X = np.zeros((pt.m_pad, 4))
    X[:600] = rng.standard_normal((600, 4))
    oracle = a.to_dense() @ X[:600]
    scale = np.abs(oracle).max()
    for precise, tol in ((True, 3e-5), (False, 2e-2)):
        Y = TS.onehot_spmm(pt, torch.as_tensor(X, dtype=torch.float32),
                           precise=precise).numpy()[:600]
        assert np.abs(Y - oracle).max() <= tol * scale


@pytest.mark.parametrize("B", [1, 3, 8])
def test_matmat_matches_ell_and_host(B):
    n = 6000
    _, p = matrix_pair(*dd_coo(n, deg=7, seed=4), (n, n), prefer="xbar")
    op = p.op(batch=True)
    assert type(op).__name__ == "CsrOperator" and op.diag_split
    rng = np.random.default_rng(B)
    X = rng.standard_normal((n, B))
    Xt = torch.as_tensor(X, dtype=torch.float32)
    before = dict(K.LAUNCHES)
    got = op.matmat(Xt)
    assert K.LAUNCHES == before  # the CPU runs the plain version
    assert got.shape == (n, B) and got.dtype == torch.float32
    ell = ell_from_csr(p.csr, device="cpu").matmat(Xt).numpy()
    host = np.stack([p.csr.matvec(X[:, j]) for j in range(B)], axis=1)
    scale = np.abs(host).max()
    assert np.abs(got.numpy() - ell).max() <= 1e-5 * scale
    assert np.abs(got.numpy() - host).max() <= 1e-5 * scale
    # a column of the batch is the single-RHS product
    np.testing.assert_allclose(got[:, 0].numpy(),
                               op.matvec(Xt[:, 0].contiguous()).numpy(),
                               rtol=0, atol=1e-5 * scale)


def test_csr_spmm_rejects_bad_operands():
    p = interop.matrix_from_reference(*_small_csr(), device="cpu",
                                      prefer="xbar")
    op = p.op()
    X = torch.ones(4, 2)
    with pytest.raises(ValueError, match="mode"):
        K.csr_spmm(op, X, mode="tf32")
    with pytest.raises(ValueError, match=r"\(m=4, B\)"):
        K.csr_spmm(op, torch.ones(4))
    tiles = TS.build_tiles(p.csr, R=128, C=128, T=128)
    with pytest.raises(ValueError, match=r"\(m=128, B\)"):
        TS.onehot_spmm(tiles, X)


def _small_csr():
    csr = CSR.from_coo(np.array([0, 1, 2, 3, 0]), np.array([0, 1, 2, 3, 3]),
                       np.array([2.0, 2.0, 2.0, 2.0, 0.5]), (4, 4))
    return csr.indptr, csr.indices, csr.data, csr.shape
