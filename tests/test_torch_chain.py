"""The port's Neumann chain (``neumann_chain``, plain version on the CPU)
against ``XbarOperator.neumann_chain`` (``_chain_call``, interpret mode),
and the chain's own contract: continuation, the residual identity, the
guards.

Tolerances: rtol 2e-5 with atol 1e-6 on acc and res and 1e-7 on the last
term, as tests/test_xbar.py uses (f32 sums taken in another order); the
squared norm rtol 2e-5 (the JAX kernel sums it in f32, the port in f64)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sublinear_tpu_torch.ops.csr_spmv import pack_csr
from sublinear_tpu_torch.formats.csr import CSR

from torch_parity import dd_coo, matrix_pair, padded, t32

torch.set_num_threads(2)

N = 500
ITERS = 6


@pytest.fixture(scope="module")
def system():
    rows, cols, vals = dd_coo(N, deg=5, seed=3)
    a, p = matrix_pair(rows, cols, vals, (N, N), prefer="xbar")
    jop, pop = a.op(), p.op()
    assert jop.chain_ready and pop.chain_ready
    b = np.random.default_rng(0).standard_normal(N).astype(np.float32)
    return a, jop, pop, b


@pytest.mark.parametrize("with_residual", [False, True, "norm"])
def test_chain_vs_jax(system, with_residual):
    _, jop, pop, b = system
    jb = jnp.asarray(padded(b, jop.m_pad))
    want = jop.neumann_chain(jop.inv_diag * jb, ITERS,
                             with_residual=with_residual)
    got = pop.neumann_chain(pop.inv_diag * t32(b), ITERS,
                            with_residual=with_residual)
    assert len(got) == len(want)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0])[:N],
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1])[:N],
                               rtol=2e-5, atol=1e-7)
    if with_residual == "norm":
        assert got[2].shape == () and got[2].dtype == torch.float32
        np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=2e-5)
    elif with_residual:
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2])[:N],
                                   rtol=2e-5, atol=1e-6)


def test_chain_matches_explicit_loop(system):
    _, _, op, b = system
    term0 = op.inv_diag * t32(b)
    acc, last = op.neumann_chain(term0, 9)
    x, term = term0, term0
    for _ in range(9):
        term = -op.inv_diag * op.offdiag_matvec(term)
        x = x + term
    np.testing.assert_allclose(acc.numpy(), x.numpy(), rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(last.numpy(), term.numpy(), rtol=2e-5,
                               atol=1e-7)


def test_two_chains_of_4_equal_one_of_8(system):
    """Chunk continuation as solvers/neumann.py uses it."""
    _, _, op, b = system
    term0 = op.inv_diag * t32(b)
    acc8, t8 = op.neumann_chain(term0, 8)
    acc4, t4 = op.neumann_chain(term0, 4)
    acc44, t44 = op.neumann_chain(t4, 4)
    x = acc4 + (acc44 - t4)
    np.testing.assert_allclose(x.numpy(), acc8.numpy(), rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(t44.numpy(), t8.numpy(), rtol=2e-5, atol=1e-7)


def test_residual_identity(system):
    """res = -R t_{iters-1} is the exact residual b - A x_{iters-1}, and it
    bounds the residual of the returned iterate."""
    a, _, op, b = system
    bt = t32(b)
    x, _, res = op.neumann_chain(op.inv_diag * bt, 12, with_residual=True)
    x_prev, _ = op.neumann_chain(op.inv_diag * bt, 11)
    np.testing.assert_allclose(res.numpy(), (bt - op.matvec(x_prev)).numpy(),
                               rtol=2e-5, atol=1e-6)
    res_final = np.linalg.norm(a.csr.matvec(x.numpy()) - b)
    assert res_final <= np.linalg.norm(res.numpy()) * 1.01 + 1e-6
    _, _, res2 = op.neumann_chain(op.inv_diag * bt, 12, with_residual="norm")
    np.testing.assert_allclose(float(res2), float(res.double().square().sum()),
                               rtol=2e-5)


def test_chain_returns_input_dtype(system):
    _, _, op, b = system
    term0 = torch.as_tensor(b, dtype=torch.float64) * op.inv_diag.double()
    acc, last, res = op.neumann_chain(term0, 3, with_residual=True)
    assert acc.dtype == last.dtype == res.dtype == torch.float64


def test_neumann_chain_guard():
    """A non-square operator is not chain-ready and must raise."""
    rng = np.random.default_rng(4)
    rows, cols = rng.integers(0, 40, 200), rng.integers(0, 60, 200)
    op = pack_csr(CSR.from_coo(rows, cols, rng.uniform(-1, 1, 200), (40, 60)),
                  device="cpu")
    assert not op.chain_ready
    with pytest.raises(ValueError, match="chain-ready"):
        op.neumann_chain(torch.zeros(60), 4)


@pytest.mark.parametrize("iters,with_residual", [(0, False), (3, "vector")])
def test_chain_argument_guards(system, iters, with_residual):
    _, _, op, b = system
    with pytest.raises(ValueError):
        op.neumann_chain(t32(b), iters, with_residual=with_residual)


def test_cg_chain_names_the_roadmap(system):
    """cg_chain, once the ROADMAP's next kernel, now keeps its contract on
    this (non-symmetric) operator too: five outputs, rz and res2 as 0-d f32
    tensors, res2 = ||r||^2 of the returned residual."""
    _, _, op, b = system
    x, r, p, rz, res2 = op.cg_chain(torch.zeros(N), t32(b), t32(b), 1.0, 4)
    assert x.shape == r.shape == p.shape == (N,)
    assert rz.shape == res2.shape == () and res2.dtype == torch.float32
    np.testing.assert_allclose(float(res2), float(r.double().square().sum()),
                               rtol=1e-6)
