"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips when no card is present (decided in the
fixture, not at import).  On a machine with a card and without jax, run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -q

(``--noconftest`` because tests/conftest.py imports jax).  This file imports
only the port.  Tolerance: max |kernel - plain| <= 1e-5 * max |plain| (f32
sums taken in another order; for csr_spmm's bf16 modes the same per-entry
roundings, summed in another order), 1e-4 for the CG chain and for bf16x3
(its bf16 split of t can round the other way).  Where the kernels promise
the same order of arithmetic (csr_spmv against a one-column csr_spmm on
short rows, a column of csr_spmm against the product of that column alone,
two runs, the chains' products against csr_spmv), the results must be
equal bit for bit.
"""
import functools

import numpy as np
import pytest
import torch

import sublinear_tpu_torch as slp
from sublinear_tpu_torch.ops import csr_spmv as K
from sublinear_tpu_torch.formats.csr import CSR
from sublinear_tpu_torch.ops import dense_fused as DF
from sublinear_tpu_torch.ops import tiled_spmm as TS
from sublinear_tpu_torch.parallel.sharded import solve_batch
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
    """The chain kernel against its plain version: one launch per chain,
    seven steps counted."""
    before, steps = K.LAUNCHES["neumann_step"], K.STEPS["neumann_step"]
    got = K.neumann_chain(op, x, 7, with_residual)
    assert K.LAUNCHES["neumann_step"] == before + 1
    assert K.STEPS["neumann_step"] == steps + 7
    want = K.neumann_chain_plain(op, x, 7, with_residual)
    for g, w in zip(got, want):
        _close(g, w)


def _cg_start(op, x):
    z = op.inv_diag * x
    return torch.zeros_like(x), x.clone(), z, K.dot64(x, z)


def _close_cg(got, want):
    """f32 CG steps amplify the differences of summation order: 1e-4 *
    max|want|."""
    for g, w in zip(got, want):
        g, w = g.double().reshape(-1), w.double().reshape(-1)
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


def test_cg_chain(op, x):
    """The CG kernel's state against the plain chain, and its launch count
    (one per chain, six steps counted).  op is asymmetric, which the
    recurrence does not mind."""
    before, steps = K.LAUNCHES["cg_step"], K.STEPS["cg_step"]
    got = K.cg_chain(op, *_cg_start(op, x), 6)
    assert K.LAUNCHES["cg_step"] == before + 1
    assert K.STEPS["cg_step"] == steps + 6
    want = K.cg_chain_plain(op, *_cg_start(op, x), 6)
    torch.cuda.synchronize()
    _close_cg(got, want)


def _check_chain_products(op, x):
    """Each step's product of both chains equals csr_spmv's bit for bit:
    the Neumann step's y = R t_in (its res = -y on the last step) and the
    CG step's q = R p + diag * p (q_out), after 1 and after 3 steps."""
    for iters in (1, 3):
        t_prev = x if iters == 1 else K.neumann_chain(op, x, iters - 1)[1]
        acc, last, res = K.neumann_chain(op, x, iters, True)
        y = K.csr_spmv(op, t_prev)
        assert torch.equal(-res, y)
        assert torch.equal(last, -(op.inv_diag * y))
        state = _cg_start(op, x)
        p_prev = (state[2] if iters == 1
                  else K.cg_chain(op, *state, iters - 1)[2])
        q = torch.empty_like(x)
        K.cg_chain(op, *state, iters, q_out=q)
        assert torch.equal(q, K.csr_spmv(op, p_prev, op.diag))


def _check_continuation(op, x):
    """A 5 + 5 chain against a 10-step one: the Neumann terms are the same
    bits (the steps are deterministic) and the sums agree; the CG states
    agree within 1e-4 (their f64 dots add block sums in no fixed order)."""
    acc10, t10 = K.neumann_chain(op, x, 10)
    acc5, t5 = K.neumann_chain(op, x, 5)
    acc55, t55 = K.neumann_chain(op, t5, 5)
    assert torch.equal(t55, t10)
    _close(acc5 + (acc55 - t5), acc10)
    state = _cg_start(op, x)
    ten = K.cg_chain(op, *state, 10)
    _close_cg(K.cg_chain(op, *K.cg_chain(op, *state, 5)[:4], 5), ten)


def test_chain_products_are_csr_spmv(op, x):
    _check_chain_products(op, x)


def test_chains_continue(op, x):
    _check_continuation(op, x)


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


@functools.lru_cache(maxsize=None)
def _dd_dense(n, full=False):
    """A seeded DD matrix as a dense f32 tensor on the card, with its diag
    and inv_diag columns and its bf16 halves: the generator's (random-sparse,
    density 0.01, at least one off-diagonal entry per row on average;
    [[1.5]] at n = 1), or with ``full`` every entry set: uniform(-1, 1) off
    the diagonal, 1.2 times the row's absolute sum on it (about 460 at
    n = 768)."""
    if full:
        a = np.random.default_rng(n).uniform(-1.0, 1.0, (n, n))
        np.fill_diagonal(a, 0.0)
        np.fill_diagonal(a, 1.2 * np.abs(a).sum(axis=1))
    elif n == 1:
        a = np.array([[1.5]])
    else:
        a = slp.generate("random-sparse", n, seed=7,
                         density=max(0.01, 1.0 / n)).to_dense()
    a = torch.as_tensor(a, dtype=torch.float32, device=torch.device("cuda"))
    d = torch.diagonal(a).clone()[:, None]
    return a, d, 1.0 / d, DF.split_bf16(a)


def _blocks(n, B, seed=3):
    """Seeded (n, B) blocks b and x0 (x0 a tenth of b's scale)."""
    rng = np.random.default_rng(seed)
    b, x0 = (s * torch.as_tensor(rng.standard_normal((n, B)),
                                 dtype=torch.float32, device="cuda")
             for s in (1.0, 0.1))
    return b, x0


def _neumann_case(kernel, n, B, iters, x0=None, seed=3, full=False):
    """(kernel call, plain call) of dense_neumann_fused or its bf16x3
    variant on _dd_dense(n, full) with _blocks(n, B, seed) (x0 unless
    given)."""
    a, d, dinv, (ah, al) = _dd_dense(n, full)
    b, x0_seeded = _blocks(n, B, seed)
    if x0 is None:
        x0 = x0_seeded
    if kernel == "dense_neumann_fused_bf16x3":
        return (lambda x=x0, t=iters: DF.dense_neumann_fused_bf16x3(
                    ah, al, d, dinv, b, x, t),
                lambda x=x0, t=iters: DF.dense_neumann_fused_bf16x3_plain(
                    ah, al, d, dinv, b, x, t))
    return (lambda x=x0, t=iters: DF.dense_neumann_fused(a, d, dinv, b, x, t),
            lambda x=x0, t=iters: DF.dense_neumann_fused_plain(
                a, d, dinv, b, x, t))


NEUMANN_KERNELS = ("dense_neumann_fused", "dense_neumann_fused_bf16x3")
# n = 3000: 36 MB of A (f32, or the two bf16 halves), more than the card's
# 30 MB of shared memory, so each block reads its last rows from global
# memory every iteration
NEUMANN_SHAPES = [(k, n) for k in NEUMANN_KERNELS
                  for n in (1, 301, 768, 1536, 3000)]


@pytest.mark.parametrize("iters", [0, 1, 8, 60])
@pytest.mark.parametrize("B", [1, 3, 4, 8, 9])
@pytest.mark.parametrize("kernel,n", NEUMANN_SHAPES)
def test_dense_neumann_persistent(card, kernel, n, B, iters):
    """The persistent Neumann kernels against their plain versions at every
    column tiling (B = 9: two tiles of 8), with no barrier (iters = 0) and
    many; n = 1 and 301 load their slabs without bulk copies.  One kernel
    call per wrapper call, and two runs equal bit for bit (no atomics)."""
    kern, plain = _neumann_case(kernel, n, B, iters)
    before = DF.LAUNCHES[kernel]
    got = kern()
    assert DF.LAUNCHES[kernel] == before + 1
    want = plain()
    torch.cuda.synchronize()
    assert got.shape == want.shape == (n, B)
    g, w = got.double(), want.double()
    rtol = 1e-4 if kernel.endswith("bf16x3") else RTOL
    assert float((g - w).abs().max()) <= rtol * float(w.abs().max())
    assert torch.equal(got, kern())


# the kernel's error against the f64 series, at most this many times the
# plain version's
WITNESS_FACTOR = 4.0


@pytest.mark.parametrize("iters", [0, 1, 8])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("kernel,n", [(k, n) for k in NEUMANN_KERNELS
                                      for n in (768, 1536)])
def test_dense_neumann_f64_witness(card, kernel, n, B, iters):
    """On the fully dense _dd_dense(n, full=True) the f32 sums cancel: the
    diagonal (about 460 at n = 768) dominates each product A t, the term is
    what is left once d t is taken off, over d, and x = x0 + term is an
    order of magnitude smaller than x0.  So kernel and plain may differ by
    more than 1e-5 of the result.  Both are held to the same series in f64
    on the same f32 inputs (for bf16x3 on A = a_hi + a_lo, exact in f64):
    the kernel's error is at most WITNESS_FACTOR times the plain version's,
    so the difference is f32 rounding, not the kernel.  Run with -s to
    print the errors."""
    a, d, dinv, (ah, al) = _dd_dense(n, True)
    b, x0 = _blocks(n, B)
    kern, plain = _neumann_case(kernel, n, B, iters, full=True)
    got, want = kern().double(), plain().double()
    a64 = (a.double() if kernel == "dense_neumann_fused"
           else ah.double() + al.double())
    exact = DF.dense_neumann_fused_plain(a64, d.double(), dinv.double(),
                                         b.double(), x0.double(), iters)
    err_k = float((got - exact).abs().max())
    err_p = float((want - exact).abs().max())
    print(f"f64 witness {kernel} n={n} B={B} iters={iters}: max |x| "
          f"{float(exact.abs().max()):.4e}, |kernel - f64| {err_k:.4e}, "
          f"|plain - f64| {err_p:.4e}, |kernel - plain| "
          f"{float((got - want).abs().max()):.4e}")
    assert err_k <= WITNESS_FACTOR * err_p


@pytest.mark.parametrize("iters", [0, 8])
@pytest.mark.parametrize("kernel", NEUMANN_KERNELS)
def test_dense_neumann_wide_block(card, kernel, iters):
    """B = 700 at n = 768: 88 column tiles, and a block's rows of x (6 x 700
    floats) past the 16 KB the kernel keeps in shared memory, so x stays in
    global memory."""
    kern, plain = _neumann_case(kernel, 768, 700, iters)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    g, w = got.double(), want.double()
    rtol = 1e-4 if kernel.endswith("bf16x3") else RTOL
    assert float((g - w).abs().max()) <= rtol * float(w.abs().max())


@pytest.mark.parametrize("kernel", NEUMANN_KERNELS)
def test_dense_neumann_continuation(card, kernel):
    """8 then 8 iterations against the plain 8 then 8, 16 against the plain
    16, and 8 then 8 against 16.  A restart recomputes the residual, so
    8 + 8 leaves the error M^18 e0 where 16 leaves M^17 e0 (M = I - D^-1 A);
    on _dd_dense's matrix (M's spectral radius about 0.3 at n = 768) both
    are the solution to f32 precision."""
    n, B = 768, 2
    rtol = 1e-4 if kernel.endswith("bf16x3") else RTOL
    kern, plain = _neumann_case(kernel, n, B, 8)
    x88 = kern(kern())
    x16 = kern(t=16)
    for got, want in ((x88, plain(plain())), (x16, plain(t=16)),
                      (x88, x16)):
        g, w = got.double(), want.double()
        assert float((g - w).abs().max()) <= rtol * float(w.abs().max())


JACOBI_POWER = ("dense_jacobi_fused", "dense_power_fused")


@functools.lru_cache(maxsize=None)
def _graph(n):
    """P^T (on the card) and the dangling column of ``_stochastic``'s seeded
    graph at n."""
    pt, _, dang = _stochastic(n, 1, torch.device("cuda"))
    return pt, dang


def _jacobi_power_case(kernel, n, B, iters, seed=3, full=False):
    """(kernel call, plain call) of dense_jacobi_fused on _dd_dense(n, full)
    with _blocks(n, B, seed), or of dense_power_fused (alpha 0.85) on
    _graph(n) with a seeded positive v whose columns sum to 1 / B.  mass
    sums dang * x over all B columns, as the Pallas kernel does, so with
    columns summing to 1 the total grows like (0.85 B)^iters at n = 1 (one
    dangling node) and overflows f32 in 60 steps; summing to 1 / B, it
    stays 1."""
    if kernel == "dense_power_fused":
        pt, dang = _graph(n)
        v = torch.as_tensor(np.random.default_rng(seed).random((n, B)) + 0.5,
                            dtype=torch.float32, device="cuda")
        v /= B * v.sum(dim=0)
        dang = dang.expand(n, B).contiguous()
        return (lambda t=iters: DF.dense_power_fused(pt, v, dang, 0.85, t),
                lambda t=iters: DF.dense_power_fused_plain(pt, v, dang, 0.85,
                                                           t))
    a, d, dinv, _ = _dd_dense(n, full)
    b, x0 = _blocks(n, B, seed)
    return (lambda t=iters: DF.dense_jacobi_fused(a, d, dinv, b, x0, t),
            lambda t=iters: DF.dense_jacobi_fused_plain(a, d, dinv, b, x0, t))


@pytest.mark.parametrize("iters", [0, 1, 8, 60])
@pytest.mark.parametrize("B", [1, 3, 4, 8, 9])
@pytest.mark.parametrize("kernel,n", [(k, n) for k in JACOBI_POWER
                                      for n in (1, 301, 768, 1536, 3000)])
def test_dense_jacobi_power_persistent(card, kernel, n, B, iters):
    """#8 and #9 on the persistent kernel against their plain versions, as
    test_dense_neumann_persistent holds #6 and #7: every column tiling, no
    product (iters = 0: a copy of x0 or v, no launch), one product (no
    barrier) and many; n = 1 and 301 load their slabs without bulk copies,
    and n = 3000 reads its last rows from global memory.  For power, B = 9
    sums mass across two column tiles, and n = 3000 over blocks whose rows
    live partly in global memory.  Two runs are equal bit for bit: every
    block adds the partials of mass in one fixed order."""
    kern, plain = _jacobi_power_case(kernel, n, B, iters)
    before = DF.LAUNCHES[kernel]
    got = kern()
    assert DF.LAUNCHES[kernel] == before + (1 if iters else 0)
    want = plain()
    torch.cuda.synchronize()
    assert got.shape == want.shape == (n, B)
    g, w = got.double(), want.double()
    assert float((g - w).abs().max()) <= RTOL * float(w.abs().max())
    assert torch.equal(got, kern())


@pytest.mark.parametrize("iters", [1, 8])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("n", [768, 1536])
def test_dense_jacobi_f64_witness(card, n, B, iters):
    """test_dense_neumann_f64_witness for #8: on the fully dense
    _dd_dense(n, full=True) the diagonal dominates A x, and x' is what is
    left once diag x is taken off, so kernel and plain may differ by more
    than 1e-5 of the result.  The kernel's error against the Jacobi sweeps
    in f64 on the same f32 inputs is at most WITNESS_FACTOR times the plain
    version's.  Run with -s to print the errors."""
    a, d, dinv, _ = _dd_dense(n, True)
    b, x0 = _blocks(n, B)
    kern, plain = _jacobi_power_case("dense_jacobi_fused", n, B, iters,
                                     full=True)
    got, want = kern().double(), plain().double()
    exact = DF.dense_jacobi_fused_plain(a.double(), d.double(), dinv.double(),
                                        b.double(), x0.double(), iters)
    err_k = float((got - exact).abs().max())
    err_p = float((want - exact).abs().max())
    print(f"f64 witness dense_jacobi_fused n={n} B={B} iters={iters}: max "
          f"|x| {float(exact.abs().max()):.4e}, |kernel - f64| {err_k:.4e}, "
          f"|plain - f64| {err_p:.4e}, |kernel - plain| "
          f"{float((got - want).abs().max()):.4e}")
    assert err_k <= WITNESS_FACTOR * err_p


@pytest.mark.parametrize("iters", [1, 8])
@pytest.mark.parametrize("kernel", JACOBI_POWER)
def test_dense_jacobi_power_wide_block(card, kernel, iters):
    """B = 700 at n = 768: 88 column tiles, and a block's rows of b (or of
    v and dang) past the 16 KB the kernel keeps in shared memory, so they
    are read from global memory; power's mass sums 88 tiles."""
    kern, plain = _jacobi_power_case(kernel, 768, 700, iters)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    g, w = got.double(), want.double()
    assert float((g - w).abs().max()) <= RTOL * float(w.abs().max())
    assert torch.equal(got, kern())


@pytest.mark.parametrize("kernel", sorted(DF.LAUNCHES))
def test_dense_one_device_launch(card, kernel):
    """A call of each dense kernel at its timed shape (B = 1, iters = 8;
    n = 768 for #6, 1536 for the others) is one device launch of the
    persistent kernel (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = 768 if kernel == "dense_neumann_fused" else 1536
    if kernel in NEUMANN_KERNELS:
        kern, _ = _neumann_case(kernel, n, 1, 8)
    else:
        kern, _ = _jacobi_power_case(kernel, n, 1, 8)
    kern()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            kern()
        torch.cuda.synchronize()
    counts = {e.key: e.count for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.count}
    launched = {k: c for k, c in counts.items() if "dense_" in k}
    assert len(launched) == 1, counts
    ((name, count),) = launched.items()
    assert "dense_fused_kernel" in name and count == 4, counts


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


EMPTY_ROW, HUB_ROW = 7, 11


@pytest.fixture(scope="module")
def spmm_op():
    """A seeded n=20,000 operator with about 8 entries per row, row 7 with
    no entries at all and row 11 a hub of 5000 off-diagonal entries."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = 20_000
    rng = np.random.default_rng(7)
    rows, cols = rng.integers(0, n, 8 * n), rng.integers(0, n, 8 * n)
    hub = rng.choice(n, 5000, replace=False)
    d = np.arange(n)
    rows = np.r_[rows, np.full(5000, HUB_ROW), d]
    cols = np.r_[cols, hub, d]
    vals = rng.uniform(-1, 1, rows.size)
    vals[-n:] = 10.0
    keep = rows != EMPTY_ROW
    csr = CSR.from_coo(rows[keep], cols[keep], vals[keep], (n, n))
    op = slp.Matrix(csr).op(batch=True)
    assert type(op).__name__ == "CsrOperator"
    counts = torch.diff(op.indptr).cpu()
    assert counts[EMPTY_ROW] == 0 and counts[HUB_ROW] >= 5000
    return op


@pytest.mark.parametrize("mode", sorted(K.SPMM_MODES))
@pytest.mark.parametrize("B", [1, 3, 8, 32, 128, 200])
def test_csr_spmm(spmm_op, mode, B):
    """Every product mode against its plain version, for scalar (B = 1, 3)
    and float4 (B = 8, 32, 128, 200) columns, B = 200 in two column slabs;
    the f32 mode with the split diagonal, as CsrOperator.matmat runs it."""
    op = spmm_op
    rng = np.random.default_rng(B)
    X = torch.as_tensor(rng.standard_normal((op.m_pad, B)),
                        dtype=torch.float32, device=op.device)
    diag = op.diag if mode == "f32" else None
    before = K.LAUNCHES["csr_spmm"]
    got = K.csr_spmm(op, X, diag, mode)
    assert K.LAUNCHES["csr_spmm"] == before + 1
    want = K.csr_spmm_plain(op, X, diag, mode)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (op.n_pad, B)
    _close(got, want)
    if diag is None:
        assert not got[EMPTY_ROW].any()


@pytest.mark.parametrize("mode", sorted(K.SPMM_MODES))
@pytest.mark.parametrize("B", [8, 200])
def test_csr_spmm_unaligned_block(spmm_op, mode, B):
    """A contiguous X whose start is 4 bytes off a 16-byte boundary takes
    the scalar path even though B % 4 == 0, in every product mode."""
    op = spmm_op
    flat = torch.randn(op.m_pad * B + 1, device=op.device)
    X = flat[1:].view(op.m_pad, B)
    diag = op.diag if mode == "f32" else None
    _close(K.csr_spmm(op, X, diag, mode),
           K.csr_spmm_plain(op, X, diag, mode))
    if mode == "f32":
        _close(op.matmat(X), K.csr_spmm_plain(op, X, op.diag))


@pytest.mark.parametrize("mode", sorted(K.SPMM_MODES))
def test_csr_spmm_columns_bit_identical(spmm_op, mode):
    """Each element of Y is one chain in CSR order, so a column of the
    product (in either of B = 200's two slabs, on the float4 path) is the
    product of that column alone (the scalar path), a block of columns the
    product of that block, and two runs are equal."""
    op = spmm_op
    X = torch.randn(op.m_pad, 200, device=op.device)
    diag = op.diag if mode == "f32" else None
    Y = K.csr_spmm(op, X, diag, mode)
    assert torch.equal(Y, K.csr_spmm(op, X, diag, mode))
    for s in (0, 31, 127, 128, 199):
        one = K.csr_spmm(op, X[:, s:s + 1].contiguous(), diag, mode)
        assert torch.equal(Y[:, s], one[:, 0]), s
    block = K.csr_spmm(op, X[:, 8:16].contiguous(), diag, mode)
    assert torch.equal(Y[:, 8:16], block)


def test_csr_spmv_is_one_column_spmm(spmm_op):
    """On rows of at most SPMV_LONG_ROW entries csr_spmv sums in csr_spmm's
    order, so the two agree bit for bit there (the hub row, summed by a
    whole block, only within the tolerance)."""
    op = spmm_op
    x = torch.randn(op.m_pad, device=op.device)
    short = torch.diff(op.indptr) <= K.SPMV_LONG_ROW
    assert not short[HUB_ROW] and int(short.sum()) == op.n_pad - 1
    for diag in (op.diag, None):
        y = K.csr_spmv(op, x, diag)
        Y = K.csr_spmm(op, x[:, None].contiguous(), diag)
        assert torch.equal(y[short], Y[short, 0])
        _close(y, Y[:, 0])
        assert torch.equal(y, K.csr_spmv(op, x, diag))


def _csr_from_lengths(lengths, m=None, seed=0):
    """A CSR whose row i holds lengths[i] entries at random columns of m,
    none on the diagonal."""
    lengths = np.asarray(lengths)
    n = lengths.size
    m = n if m is None else m
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), lengths)
    cols = rng.integers(0, m, rows.size)
    if n == m:
        cols = np.where(cols == rows, (rows + 1) % n, cols)
    return CSR(np.r_[0, np.cumsum(lengths)], cols,
               rng.uniform(-1, 1, rows.size), (n, m))


SPMV_CASES = {
    "empty_rows": np.where(np.arange(3000) % 3 == 0, 0, 7),
    "row_past_tile": np.r_[np.full(40, 6), 5000, np.full(40, 6)],
    "long_rows": np.r_[np.full(30, 5), 65, 64, 1024, 1025, np.full(30, 5)],
    "tile_boundary": np.full(640, 16),  # 64 rows fill a tile exactly
    "n_not_block_multiple": np.full(1037, 2),
    "one_row": np.array([0]),
    "no_offdiag": np.zeros(900, int),
}


@pytest.mark.parametrize("case", sorted(SPMV_CASES) + ["rectangular"])
def test_csr_spmv_shapes(card, case):
    """csr_spmv against its plain version where the row blocks have edges:
    empty rows, a row longer than the tile, rows just over and at the long
    row threshold, rows ending on a tile boundary, n not a multiple of the
    block's rows, n = 1, no off-diagonal entries and a rectangular
    operator; with and without the diagonal where the operator is square."""
    csr = (_csr_from_lengths(np.random.default_rng(2).poisson(4, 300), 900)
           if case == "rectangular" else _csr_from_lengths(SPMV_CASES[case]))
    op = K.pack_csr(csr, device=card)
    x = torch.as_tensor(np.random.default_rng(3).uniform(-1, 1, op.m_pad),
                        dtype=torch.float32, device=card)
    for diag in ((op.diag, None) if op.diag_split else (None,)):
        before = K.LAUNCHES["csr_spmv"]
        got = K.csr_spmv(op, x, diag)
        assert K.LAUNCHES["csr_spmv"] == before + 1
        want = K.csr_spmv_plain(op, x, diag)
        torch.cuda.synchronize()
        assert got.shape == want.shape == (op.n_pad,)
        if want.abs().max() == 0:
            assert not got.any()
        else:
            _close(got, want)


def _with_diagonal(csr):
    """csr plus a diagonal of 1.5 * |off-diagonal row sum| + 1 (strictly
    diagonally dominant)."""
    rows, cols, vals = csr.to_coo()
    n = csr.shape[0]
    d = np.arange(n)
    diag = 1.5 * np.bincount(rows, weights=np.abs(vals), minlength=n) + 1.0
    return CSR.from_coo(np.r_[rows, d], np.r_[cols, d], np.r_[vals, diag],
                        (n, n))


@pytest.mark.parametrize("case", sorted(SPMV_CASES))
def test_chains_shapes(card, case):
    """Both chains on csr_spmv's edge shapes, with a diagonal added: against
    their plain versions (Neumann 1e-5, the 10-step CG chain 1e-4), their
    products against csr_spmv bit for bit, and 5 + 5 steps against 10."""
    op = K.pack_csr(_with_diagonal(_csr_from_lengths(SPMV_CASES[case])),
                    device=card)
    x = torch.as_tensor(np.random.default_rng(3).uniform(-1, 1, op.n_pad),
                        dtype=torch.float32, device=card)
    for wr in (False, True, "norm"):
        got = K.neumann_chain(op, x, 12, wr)
        for g, w in zip(got, K.neumann_chain_plain(op, x, 12, wr)):
            _close(g, w)
    _close_cg(K.cg_chain(op, *_cg_start(op, x), 10),
              K.cg_chain_plain(op, *_cg_start(op, x), 10))
    _check_chain_products(op, x)
    _check_continuation(op, x)


def test_operator_check_is_cached(card):
    """The operator's arrays are checked once, then again only when one of
    them is another tensor; a check that fails raises every time."""
    op = K.pack_csr(_csr_from_lengths(np.full(500, 5)), device=card)
    x = torch.ones(500, device=card)
    K.csr_spmv(op, x)
    assert op._checked is not None
    op.vals = op.vals.double()
    for _ in range(2):
        with pytest.raises(ValueError, match="vals"):
            K.csr_spmv(op, x)
    with pytest.raises(ValueError, match="x:"):
        K.csr_spmv(K.pack_csr(_csr_from_lengths(np.full(500, 5)),
                              device=card), x[:499])


@pytest.mark.parametrize("precise", [True, False])
def test_onehot_spmm_on_card(card, precise):
    a = slp.generate("random-sparse", 3000, seed=7, density=3e-3)
    tiles = TS.build_tiles(a.csr)
    assert tiles.csr.device.type == "cuda"
    X = torch.randn(tiles.m_pad, 16, device=card)
    before = K.LAUNCHES["csr_spmm"]
    got = TS.onehot_spmm(tiles, X, precise)
    assert K.LAUNCHES["csr_spmm"] == before + 1
    _close(got, TS.onehot_spmm_plain(tiles, X, precise))


def test_solve_batch_on_card(card):
    """A 40-RHS Neumann batch on the "csr" route: one csr_spmm launch per
    iteration (the count starts at 1 with the seed term and the final
    residual takes one), every column converged."""
    a = slp.generate("random-sparse", 20_000, seed=7, density=5e-4)
    B = np.random.default_rng(0).standard_normal((20_000, 40))
    before = dict(K.LAUNCHES)
    results = solve_batch(a, B, method="neumann")
    assert K.LAUNCHES["csr_spmm"] - before["csr_spmm"] == results[0].iterations
    assert K.LAUNCHES["neumann_step"] == before["neumann_step"]
    for j, r in enumerate(results):
        rel = (np.linalg.norm(a.csr.matvec(r.solution) - B[:, j])
               / np.linalg.norm(B[:, j]))
        assert r.converged and r.method == "neumann-batch" and rel < 1e-5


# ------------------------------------------------------------ solver family

def _strong_dd_card(n=2000, seed=6):
    a = slp.generate("random-sparse", n, seed=seed, density=4.0 / n)
    return slp.Matrix(a.csr.add_diagonal(2.0), prefer="xbar")


@pytest.mark.parametrize("method", ["jacobi", "gauss-seidel", "sor"])
def test_stationary_launches_csr_spmv(card, method):
    """A sweep is one csr_spmv per color (1 for Jacobi) and each residual
    check one more: k * colors + k / check_every + 1 launches."""
    from sublinear_tpu_torch.solvers.jacobi import greedy_coloring

    a = slp.generate("random-sparse", 20_000, seed=7, density=5e-4)
    assert a._op_kind() == "csr"
    b = slp.rhs(20_000, seed=7)
    colors = 1 if method == "jacobi" else int(greedy_coloring(a).max()) + 1
    before = K.LAUNCHES["csr_spmv"]
    r = slp.solve(a, b, method=method, epsilon=1e-6, check_every=5)
    k = r.iterations
    assert r.converged and r.method == method and k % 5 == 0
    assert K.LAUNCHES["csr_spmv"] - before == k * colors + k // 5 + 1
    rel = np.linalg.norm(a.csr.matvec(r.solution) - b) / np.linalg.norm(b)
    assert rel < 1e-5


@pytest.mark.parametrize("strategy", ["importance", "uniform", "stratified",
                                      "qmc"])
def test_walks_on_card_rerun_bit_identical(card, strategy):
    """One seed, two runs on the card: the same walkers bit for bit.  The
    importance walkers are also unbiased: 99% of 2000 entries within 5
    standard errors of the exact solution."""
    from sublinear_tpu_torch.solvers import random_walk as RW

    a = _strong_dd_card()
    b = slp.rhs(2000, seed=6)
    starts = np.repeat(np.arange(2000), 64)
    opts = slp.SolverOptions(seed=3, sampling=strategy)
    acc1, t1 = RW.run_walks(a, b, starts, opts, group=64)
    acc2, t2 = RW.run_walks(a, b, starts, opts, group=64)
    assert RW.sampling_tables(a).cdf.device.type == "cuda"
    np.testing.assert_array_equal(acc1, acc2)
    assert t1 == t2 > 0
    if strategy == "importance":
        x = np.linalg.solve(a.to_dense(), b)
        acc = acc1.reshape(2000, 64)
        se = np.sqrt(acc.var(axis=1, ddof=1) / 64)
        assert np.mean(np.abs(acc.mean(axis=1) - x) <= 5 * se + 1e-6) >= 0.99


def test_bmssp_on_card_equals_cpu(card):
    from sublinear_tpu_torch.solvers import bmssp as BM

    a = slp.generate("random-sparse", 20_000, seed=7, density=5e-4)
    cpu = slp.Matrix(a.csr, device="cpu")
    sources = [3, 77, 4000, 19_999]
    vals = [1.0, 2.0, -1.0, 0.5]
    dg, xg, sg = BM.shortest_paths(a, sources, vals)
    dc, xc, sc = BM.shortest_paths(cpu, sources, vals)
    assert sg == sc
    np.testing.assert_array_equal(dg, dc)
    np.testing.assert_array_equal(xg, xc)
    bg = BM.batched_distances(a, [0, 5, 900])
    bc = BM.batched_distances(cpu, [0, 5, 900])
    np.testing.assert_array_equal(bg, bc)


def test_streaming_panels_equal_matvec(card):
    from sublinear_tpu_torch.formats.streaming import StreamingOperator

    a = slp.generate("random-sparse", 50_000, seed=7, density=2e-4)
    sop = StreamingOperator(a.csr, panel_budget=20_000, device=card)
    assert sop.n_panels >= 8
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(50_000),
                        dtype=torch.float32, device=card)
    before = K.LAUNCHES["csr_spmv"]
    got = sop.matvec_device(x)
    assert K.LAUNCHES["csr_spmv"] - before == sop.n_panels
    _close(got, a.op().matvec(x))
    # a second product reuses the slot and gives the same bits
    assert torch.equal(sop.matvec_device(x), got)


def test_refined_device_residual_matches_host(card):
    from sublinear_tpu_torch.solvers.refine import DeviceResidual, solve_refined

    a = slp.generate("random-sparse", 20_000, seed=7, density=5e-4)
    b = slp.rhs(20_000, seed=7)
    x = np.random.default_rng(3).standard_normal(20_000)
    r = DeviceResidual(a, b)(torch.as_tensor(x, device=card))
    want = b - a.csr.matvec(x)
    assert float(np.abs(r.cpu().numpy() - want).max()) <= 1e-12 * float(
        np.abs(want).max())
    out = solve_refined(a, b, slp.SolverOptions(epsilon=1e-12))
    rel = np.linalg.norm(a.csr.matvec(out.solution) - b) / np.linalg.norm(b)
    assert out.converged and rel <= 1e-12
    assert abs(out.residual / np.linalg.norm(b) - rel) <= 1e-12


# ------------------------------------------------------------ graph layer

def _web_graph(n=20_000, out=5, seed=3, device=None):
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(n), out)
    c = rng.integers(0, n, out * n)
    keep = r != c
    return slp.Matrix.from_coo(r[keep], c[keep], np.ones(int(keep.sum())),
                               (n, n), device=device)


@pytest.mark.parametrize("personalized", [False, True])
def test_pagerank_on_card_equals_cpu(card, personalized):
    from sublinear_tpu_torch.graph import pagerank, personalized_pagerank

    g, cpu = _web_graph(device=card), _web_graph(device="cpu")
    if personalized:
        got = personalized_pagerank(g, [0, 7, 19_999])
        want = personalized_pagerank(cpu, [0, 7, 19_999])
    else:
        got, want = pagerank(g), pagerank(cpu)
    assert got.converged and want.converged
    assert abs(got.iterations - want.iterations) <= 5
    np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=1e-5)
    assert abs(got.scores.sum() - 1.0) < 1e-5


def test_pagerank_launches_six_per_block(card):
    """P^T of a large sparse graph takes the "csr" route: each block of 5
    steps launches csr_spmv 5 times plus once for its residual check, after
    one launch for the initial residual."""
    from sublinear_tpu_torch.graph.pagerank import pagerank_inputs, pagerank_run

    opT, v, dangling = pagerank_inputs(_web_graph(device=card))
    assert type(opT).__name__ == "CsrOperator"
    before = K.LAUNCHES["csr_spmv"]
    x, k, res = pagerank_run(opT, v, dangling, 0.85, 1e-6, 1000)
    blocks = k // 5
    assert k % 5 == 0 and blocks > 0 and res <= 1e-6 and x.is_cuda
    assert K.LAUNCHES["csr_spmv"] - before == 1 + 6 * blocks
