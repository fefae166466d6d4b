"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips when no card is present (decided in the
fixture, not at import).  On a machine with a card and without jax, run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q

(``--noconftest`` because tests/conftest.py imports jax).  This file imports
only the port.  Tolerance: max |kernel - plain| <= 1e-5 * max |plain| (f32
sums taken in another order), 1e-4 for the CG chain and for bf16x3 (its
bf16 split of t can round the other way).
"""
import numpy as np
import pytest
import torch

import sublinear_tpu_torch as slp
from sublinear_tpu_torch.ops import csr_spmv as K
from sublinear_tpu_torch.ops import dense_fused as DF
from sublinear_tpu_torch.solvers.fused import solve_neumann_fused

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


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _dense_inputs(n, B, seed=7):
    """A seeded DD matrix on the dense route, with (n, B) blocks."""
    a = slp.generate("random-sparse", n, seed=seed, density=0.05)
    op = a.op()
    assert type(op).__name__ == "DenseOperator"
    rng = np.random.default_rng(seed)
    b, x0 = (torch.as_tensor(s * rng.standard_normal((n, B)),
                             dtype=torch.float32, device=op.data.device)
             for s in (1.0, 0.1))
    return op, op.diag[:, None], op.inv_diag[:, None], b, x0


def _stochastic(n, B, dev, seed=7):
    """(P^T, v, dangling) of a seeded random graph with dangling nodes."""
    rng = np.random.default_rng(seed)
    adj = (rng.random((n, n)) < 0.05).astype(np.float64)
    np.fill_diagonal(adj, 0.0)
    adj[: n // 8] = 0.0
    deg = adj.sum(axis=1)
    pt = (adj / np.where(deg > 0, deg, 1.0)[:, None]).T
    v = rng.random((n, B)) + 0.5
    v /= v.sum(axis=0)
    dang = np.repeat((deg == 0).astype(np.float64)[:, None], B, 1)
    return (torch.as_tensor(m, dtype=torch.float32, device=dev).contiguous()
            for m in (pt, v, dang))


def _dense_call(kernel, n, B, dev):
    """(kernel output, plain output) of one dense kernel at (n, B)."""
    if kernel == "dense_power_fused":
        pt, v, dang = _stochastic(n, B, dev)
        return (DF.dense_power_fused(pt, v, dang, 0.85, 8),
                DF.dense_power_fused_plain(pt, v, dang, 0.85, 8))
    op, d, dinv, b, x0 = _dense_inputs(n, B)
    if kernel == "dense_neumann_fused_bf16x3":
        ah, al = DF.split_bf16(op.data)
        return (DF.dense_neumann_fused_bf16x3(ah, al, d, dinv, b, x0, 8),
                DF.dense_neumann_fused_bf16x3_plain(ah, al, d, dinv, b, x0,
                                                    8))
    fn = getattr(DF, kernel)
    plain = getattr(DF, kernel + "_plain")
    return (fn(op.data, d, dinv, b, x0, 8),
            plain(op.data, d, dinv, b, x0, 8))


@pytest.mark.parametrize("kernel", sorted(DF.LAUNCHES))
@pytest.mark.parametrize("n,B", [(301, 1), (301, 9), (768, 4), (1536, 1)])
def test_dense_kernel(card, kernel, n, B):
    """Each dense kernel against its plain version: a row count that is not
    a multiple of 4 (scalar loads), column tiles of 1, 4 and 8 (B = 9 needs
    two tiles, the second mostly masked), and the path's widest n."""
    before = DF.LAUNCHES[kernel]
    got, want = _dense_call(kernel, n, B, card)
    assert DF.LAUNCHES[kernel] == before + 1
    torch.cuda.synchronize()
    assert got.shape == want.shape == (n, B)
    g, w = got.double(), want.double()
    rtol = 1e-4 if kernel.endswith("bf16x3") else RTOL
    assert float((g - w).abs().max()) <= rtol * float(w.abs().max())


def test_dense_neumann_continues_and_rejects_cpu_mix(card):
    op, d, dinv, b, x0 = _dense_inputs(400, 2)
    x8 = DF.dense_neumann_fused(op.data, d, dinv, b, x0, 8)
    x88 = DF.dense_neumann_fused(op.data, d, dinv, b, x8, 8)
    want = DF.dense_neumann_fused_plain(op.data, d, dinv, b, x8, 8)
    _close(x88, want)
    with pytest.raises(ValueError, match="b:"):
        DF.dense_neumann_fused(op.data, d, dinv, b.cpu(), x0, 8)


@pytest.mark.parametrize("n,eps,method", [
    (768, 1e-6, "neumann-fused-highest"),
    (1536, 1e-3, "neumann-fused-bf16x3"),
])
def test_solve_neumann_fused_on_card(card, n, eps, method):
    a = slp.generate("random-sparse", n, seed=7, density=0.01)
    b = slp.rhs(n, seed=7)
    name = ("dense_neumann_fused_bf16x3" if method.endswith("bf16x3")
            else "dense_neumann_fused")
    before = DF.LAUNCHES[name]
    r = solve_neumann_fused(a, b, slp.SolverOptions(epsilon=eps))
    rel = np.linalg.norm(a.csr.matvec(r.solution) - b) / np.linalg.norm(b)
    assert r.converged and r.method == method and rel < 10 * eps
    assert DF.LAUNCHES[name] > before
