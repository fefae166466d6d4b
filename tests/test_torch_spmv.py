"""The port's CSR product (``csr_spmv``, plain version on the CPU) against
the JAX package's crossbar product: ``XbarOperator.matvec`` and
``offdiag_matvec`` (``_fused_call``, interpret mode), and ``_k1_call``
composed with ``_k2_call`` directly on the same ``pack_xbar`` tables; and
the host side of the ``csr_spmv`` kernel, its row-block partition
(``CsrOperator.row_blocks``).

Tolerance rtol = atol = 2e-5, as tests/test_xbar.py uses: f32 sums taken in
another order."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sublinear_tpu.ops.xbar import _k1_call, _k2_call, pack_xbar
from sublinear_tpu_torch.formats.csr import CSR
from sublinear_tpu_torch.ops import csr_spmv as K

from torch_parity import dd_coo, matrix_pair, padded, port_on_cpu, t32

torch.set_num_threads(2)

N = 600
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def system():
    rows, cols, vals = dd_coo(N, deg=5, seed=21)
    a, p = matrix_pair(rows, cols, vals, (N, N), prefer="xbar")
    jop = a.op()
    assert type(jop).__name__ == "XbarOperator" and jop.fused
    x = np.random.default_rng(22).standard_normal(N).astype(np.float32)
    return a, p, jop, p.op(), x


def test_matvec_vs_fused_call(system):
    a, _, jop, pop, x = system
    want = np.asarray(jop.matvec(jnp.asarray(padded(x, jop.m_pad))))[:N]
    got = pop.matvec(t32(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, a.csr.matvec(x), **TOL)


def test_offdiag_vs_fused_call(system):
    _, _, jop, pop, x = system
    want = np.asarray(jop.offdiag_matvec(jnp.asarray(padded(x, jop.m_pad))))[:N]
    np.testing.assert_allclose(pop.offdiag_matvec(t32(x)).numpy(), want, **TOL)


def test_offdiag_vs_k1_k2_composed():
    """The two-kernel HBM-spill schedule of the same product."""
    rows, cols, vals = dd_coo(N, deg=5, seed=23)
    jop = pack_xbar(rows, cols, vals, (N, N))
    assert jop.tail_nnz == 0 and jop.diag_split
    x = np.random.default_rng(24).standard_normal(N).astype(np.float32)
    x2d = jnp.asarray(padded(x, jop.m_pad)).reshape(jop.C_src, 128)
    o2t = _k1_call(jop.C_src, jop.Bs, jop.Bd, jop.banks, jop.cb_s)(
        x2d, jop.idx_src, jop.val_src, jop.idx2)
    y2d = _k2_call(jop.Bs, jop.Bd, jop.K, jop.Cb_pad)(o2t, jop.idx3)
    want = np.asarray(y2d).reshape(-1)[:N]
    _, p = matrix_pair(rows, cols, vals, (N, N), prefer="xbar")
    np.testing.assert_allclose(p.op().offdiag_matvec(t32(x)).numpy(), want,
                               **TOL)


def test_matvec_f64_input_returns_f64(system):
    """The operator computes in f32 and hands back the input's dtype, as
    XbarOperator does."""
    a, _, _, pop, x = system
    y = pop.matvec(torch.as_tensor(x, dtype=torch.float64))
    assert y.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), a.csr.matvec(x), **TOL)


def test_rectangular_keeps_every_entry():
    n, m = 300, 900
    rng = np.random.default_rng(3)
    rows, cols = rng.integers(0, n, 1500), rng.integers(0, m, 1500)
    vals = rng.uniform(-1, 1, 1500)
    a, p = matrix_pair(rows, cols, vals, (n, m), prefer="xbar")
    op = p.op()
    assert not op.diag_split and not op.chain_ready
    assert op.indices.numel() == a.csr.nnz
    x = rng.standard_normal(m)
    np.testing.assert_allclose(op.matvec(t32(x)).numpy(), a.csr.matvec(x),
                               **TOL)


def test_transpose_operator():
    rows, cols, vals = dd_coo(400, deg=4, seed=25)
    a, p = matrix_pair(rows, cols, vals, (400, 400), prefer="xbar")
    x = np.random.default_rng(26).standard_normal(400)
    got = p.op(transpose=True).matvec(t32(x)).numpy()
    np.testing.assert_allclose(got, a.to_dense().T @ x, **TOL)


def test_plain_version_on_cpu_launches_nothing(system):
    _, _, _, pop, x = system
    before = dict(K.LAUNCHES)
    K.csr_spmv(pop, t32(x), pop.diag)
    K.neumann_chain(pop, t32(x), 3, "norm")
    assert K.LAUNCHES == before


def test_kernel_wrapper_rejects_cpu_operator(system):
    _, _, _, pop, x = system
    with pytest.raises(ValueError, match="CUDA kernel operands"):
        K._check_operands(pop, x=(t32(x), N))


def _csr_from_lengths(lengths, m=None, seed=0):
    """A CSR whose row i holds lengths[i] entries at random columns of m."""
    lengths = np.asarray(lengths)
    n = lengths.size
    m = n if m is None else m
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), lengths)
    cols = rng.integers(0, m, rows.size)
    return CSR(np.r_[0, np.cumsum(lengths)], cols,
               rng.uniform(-1, 1, rows.size), (n, m))


# row lengths of the off-diagonal CSR (pack_csr drops no entry of these:
# their columns are drawn apart from the diagonal below)
PARTITION_CASES = {
    "random": np.random.default_rng(1).poisson(10, 5000),
    "empty_rows": np.where(np.arange(3000) % 3 == 0, 0, 7),
    "all_empty_runs": np.r_[np.zeros(700, int), np.full(50, 12),
                            np.zeros(600, int)],
    "hub_past_tile": np.r_[np.full(40, 6), 5000, np.full(40, 6)],
    "long_rows": np.r_[np.full(30, 5), 65, 64, 1024, 1025, np.full(30, 5)],
    "tile_boundary": np.full(640, 16),  # 64 rows fill a tile exactly
    "n_not_block_multiple": np.full(1037, 2),
    "one_row": np.array([0]),
    "no_offdiag": np.zeros(900, int),
}


def _offdiag_op(lengths, m=None):
    """A CPU CsrOperator whose off-diagonal CSR has the given row lengths."""
    csr = _csr_from_lengths(lengths, m)
    n, m = csr.shape
    if n == m:  # keep every entry off the diagonal
        rows = csr.row_of_entry()
        cols = np.where(csr.indices == rows, (rows + 1) % n, csr.indices)
        csr = CSR(csr.indptr, cols, csr.data, csr.shape)
    return K.pack_csr(csr, device="cpu")


@pytest.mark.parametrize("case", sorted(PARTITION_CASES) + ["rectangular"])
def test_row_blocks_partition(case):
    """The row blocks cover every row once and in order; a block holds at
    most SPMV_ROWS rows and SPMV_TILE entries unless it is one long row; a
    row of more than SPMV_LONG_ROW entries is a block alone; and each block
    of short rows is as long as the limits allow (the greedy cut)."""
    if case == "rectangular":
        op = _offdiag_op(np.random.default_rng(2).poisson(4, 300), m=900)
        assert op.shape == (300, 900) and not op.diag_split
    else:
        op = _offdiag_op(PARTITION_CASES[case])
    indptr = op.indptr.numpy().astype(np.int64)
    n = op.n_pad
    lengths = np.diff(indptr)
    blocks = op.row_blocks
    assert blocks.dtype == torch.int32 and blocks.device == op.device
    b = blocks.numpy().astype(np.int64)
    assert b[0] == 0 and b[-1] == n and np.all(np.diff(b) >= 1)
    for r0, r1 in zip(b[:-1], b[1:]):
        entries = indptr[r1] - indptr[r0]
        long = lengths[r0:r1] > K.SPMV_LONG_ROW
        if long.any():
            assert r1 - r0 == 1
            continue
        assert r1 - r0 <= K.SPMV_ROWS and entries <= K.SPMV_TILE
        if r1 < n:  # the next row would break a limit, or is long
            assert (r1 - r0 == K.SPMV_ROWS
                    or entries + lengths[r1] > K.SPMV_TILE
                    or lengths[r1] > K.SPMV_LONG_ROW)


def test_row_blocks_tile_boundary():
    """Rows of 16 entries: each block is 64 rows, ending on the tile."""
    b = K.spmv_row_blocks(np.arange(0, 16 * 640 + 1, 16))
    np.testing.assert_array_equal(b, np.arange(0, 641, 64))


def test_row_blocks_built_lazily():
    """The partition is built at first use and then kept; the CPU product
    (the plain version) never builds it."""
    op = _offdiag_op(PARTITION_CASES["random"])
    assert op._row_blocks is None
    op.matvec(torch.ones(op.m_pad))
    assert op._row_blocks is None
    first = op.row_blocks
    assert op._row_blocks is first and op.row_blocks is first


def test_row_block_limits_match_kernel_source():
    """The partition's limits are the csr_spmv kernel's compile-time ones."""
    src = (Path(K.__file__).resolve().parent.parent / "csrc"
           / "csr_kernels.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\w+);", src))
    assert int(consts["kTile"]) == K.SPMV_TILE
    assert int(consts["kLongRow"]) == K.SPMV_LONG_ROW
    assert consts["kTileRows"] == "kStreamThreads"
    assert int(consts["kStreamThreads"]) == K.SPMV_ROWS
