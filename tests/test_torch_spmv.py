"""The port's CSR product (``csr_spmv``, plain version on the CPU) against
the JAX package's crossbar product: ``XbarOperator.matvec`` and
``offdiag_matvec`` (``_fused_call``, interpret mode), and ``_k1_call``
composed with ``_k2_call`` directly on the same ``pack_xbar`` tables.

Tolerance rtol = atol = 2e-5, as tests/test_xbar.py uses: f32 sums taken in
another order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sublinear_tpu.ops.xbar import _k1_call, _k2_call, pack_xbar
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
