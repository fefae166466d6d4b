"""The port's batch path (parallel/sharded.py::solve_batch) against the JAX
package's, on the CPU.

Both packages solve the same numpy-seeded systems.  At n=16384 (about 8 or
11 entries per row) the JAX package takes ELL for a batch and the port the
``"csr"`` operator, whose ``matmat`` is the ``csr_spmm`` kernel (its plain
version here); at n=2000 both take the dense route.  Tolerances: each
column's solution within 1e-4 relative of the JAX result (f32 iterations
with sums in another order), iteration counts within 1, the same
``converged`` flags and method strings, and each column's host f64 relative
residual within 10 * epsilon.
"""
import numpy as np
import pytest
import torch

import sublinear_tpu as slt
import sublinear_tpu_torch as slp
from sublinear_tpu.parallel import sharded as JS
from sublinear_tpu_torch.errors import SolverError as PortSolverError
from sublinear_tpu_torch.ops.csr_spmv import CsrOperator
from sublinear_tpu_torch.parallel import sharded as PS

from torch_parity import dd_coo, matrix_pair, port_on_cpu, spd_coo

torch.set_num_threads(2)

EPS = 1e-6
SYSTEMS = {  # name: (n, COO triplets)
    "dd16384": (16384, lambda: dd_coo(16384, deg=7, seed=0)),
    "spd16384": (16384, lambda: spd_coo(16384, seed=3)),
    "dd2000": (2000, lambda: dd_coo(2000, deg=7, seed=1)),
    "spd2000": (2000, lambda: spd_coo(2000, seed=5)),
}
_pairs = {}


def pair(name):
    """(JAX Matrix, port Matrix) of a system, built once per module."""
    if name not in _pairs:
        n, coo = SYSTEMS[name]
        _pairs[name] = matrix_pair(*coo(), (n, n))
    return _pairs[name]


def rhs_block(n, nrhs, seed=0, scales=None):
    B = np.random.default_rng(seed).standard_normal((n, nrhs))
    return B if scales is None else B * scales[None, :]


def host_rel(p, x, b):
    return np.linalg.norm(p.csr.matvec(x) - b) / np.linalg.norm(b)


def test_batch_op_kind_differs_on_purpose():
    """A large sparse batch: ELL in the JAX package, "csr" in the port (its
    operator has a batched product); at n <= DENSE_THRESHOLD both dense."""
    a, p = pair("dd16384")
    assert a._op_kind(batch=True) == "ell"
    assert p._op_kind(batch=True) == p._op_kind() == "csr"
    assert type(p.op(batch=True)) is CsrOperator
    a2, p2 = pair("dd2000")
    assert a2._op_kind(batch=True) == p2._op_kind(batch=True) == "dense"


@pytest.mark.parametrize("system,method,expect", [
    ("dd16384", "neumann", "neumann-batch"),
    ("spd16384", "cg", "cg-batch"),
    ("spd16384", "auto", "cg-batch"),
    ("dd2000", "neumann", "neumann-batch"),
    ("dd2000", "auto", "neumann-batch"),
    ("spd2000", "cg", "cg-batch"),
])
def test_solve_batch_matches_jax(system, method, expect):
    a, p = pair(system)
    n = a.shape[0]
    B = rhs_block(n, 8)
    # check_every=1 keeps an 8-column Neumann batch off the chain path in
    # both packages; the batch loops do not read it
    want = JS.solve_batch(a, B, slt.SolverOptions(epsilon=EPS, check_every=1),
                          method=method)
    got = PS.solve_batch(p, B, slp.SolverOptions(epsilon=EPS, check_every=1),
                         method=method)
    assert len(got) == len(want) == 8
    for j, (w, g) in enumerate(zip(want, got)):
        assert g.method == w.method == expect
        assert g.converged and w.converged
        assert abs(g.iterations - w.iterations) <= 1
        assert g.solution.shape == (n,)
        err = np.linalg.norm(g.solution - w.solution) / np.linalg.norm(
            w.solution)
        assert err <= 1e-4, (j, err)
        assert g.residual <= EPS * np.linalg.norm(B[:, j]) * 1.0000001
        assert host_rel(p, g.solution, B[:, j]) <= 10 * EPS


@pytest.mark.parametrize("method", ["neumann", "cg"])
def test_per_column_thresholds(method):
    """Column norms spanning 12 orders of magnitude: each column meets its
    own relative tolerance, not eps * max_j ||b_j|| (the case of
    tests/test_parallel.py::test_batch_solve_per_column_tolerance, here on
    the port's "csr" batch route)."""
    _, p = pair("spd16384")
    scales = 10.0 ** np.linspace(-6, 6, 36)
    B = rhs_block(16384, 36, seed=2, scales=scales)
    results = PS.solve_batch(p, B, method=method)
    for j, r in enumerate(results):
        assert r.converged, (method, j)
        assert host_rel(p, r.solution, B[:, j]) <= 10 * EPS, (method, j)


@pytest.mark.parametrize("method,extra", [("neumann", 0), ("cg", 1)])
def test_batch_products_per_solve(monkeypatch, method, extra):
    """The batch loop's products: Neumann starts at k=1 from the seed term
    and skips the product of X0 = 0, so it runs `iterations` products (one
    per pass and the final residual); CG runs one more (B - A X0)."""
    calls = []
    real = CsrOperator.matmat

    def counted(self, X):
        calls.append(X.shape)
        return real(self, X)

    monkeypatch.setattr(CsrOperator, "matmat", counted)
    _, p = pair("spd16384")
    results = PS.solve_batch(p, rhs_block(16384, 40, seed=4), method=method)
    assert all(r.converged for r in results)
    assert len(calls) == results[0].iterations + extra
    assert set(calls) == {(16384, 40)}


def test_small_batch_runs_serialized_chain_solves(monkeypatch):
    """<= 32 Neumann RHS on a chain-ready operator: one chain solve per
    column (CsrOperator.neumann_chain), no batched product; each column
    checked against the host f64 residual."""
    def no_batch(*_):
        raise AssertionError("the small batch ran the batched loop")

    monkeypatch.setattr(PS, "_neumann_batch_run", no_batch)
    monkeypatch.setattr(CsrOperator, "matmat", no_batch)
    chains = []
    real = CsrOperator.neumann_chain

    def counted(self, *args, **kw):
        chains.append(args[1])
        return real(self, *args, **kw)

    monkeypatch.setattr(CsrOperator, "neumann_chain", counted)
    _, p = pair("dd16384")
    B = rhs_block(16384, 20, seed=6, scales=10.0 ** np.linspace(-3, 3, 20))
    results = PS.solve_batch(p, B, method="neumann")
    assert len(chains) >= 20
    iters = results[0].iterations
    for j, r in enumerate(results):
        assert r.method == "neumann-batch" and r.converged
        assert r.iterations == iters
        assert host_rel(p, r.solution, B[:, j]) < 1e-5, j
        assert r.residual <= EPS * np.linalg.norm(B[:, j]) * 1.0000001


def test_bad_shape_raises_e005_in_both():
    a, p = pair("dd2000")
    for bad in (np.ones((1999, 3)), np.ones(2000)):
        with pytest.raises(slt.SolverError) as jexc:
            JS.solve_batch(a, bad)
        with pytest.raises(PortSolverError) as pexc:
            PS.solve_batch(p, bad)
        assert jexc.value.code == pexc.value.code == "E005"


def test_mesh_is_not_ported():
    _, p = pair("dd2000")
    with pytest.raises(NotImplementedError, match="queue 1, item 11"):
        PS.solve_batch(p, np.ones((2000, 2)), mesh=object())


# ---------------------------------------------- B and X prepared on the device

PREP_N = 4096  # the smallest size that the sparse kernels' route takes
_prep_systems = {}


def prep_system(kind):
    """A port Matrix on the "csr" route: DD for Neumann, SPD for CG."""
    if kind not in _prep_systems:
        coo = dd_coo(PREP_N, seed=11) if kind == "dd" else spd_coo(PREP_N,
                                                                    seed=12)
        _prep_systems[kind] = slp.Matrix.from_coo(*coo, (PREP_N, PREP_N),
                                                  prefer="csr")
    return _prep_systems[kind]


def host_prepared_solve(A, B, method, options):
    """solve_batch as it prepared B and X on the host: the thresholds from
    ``np.linalg.norm`` of B in float64, B made float32 by NumPy (as
    (nrhs, n) rows for the chain branch), X widened by NumPy; the same
    loops.  Returns (X, iterations, column residuals, converged flags)."""
    B = np.asarray(B, dtype=np.float64)
    thr = options.epsilon * np.maximum(np.linalg.norm(B, axis=0), 1e-30)
    if method == "chain":
        Bt = torch.from_numpy(np.ascontiguousarray(B.T, dtype=np.float32))
        X, k, res = PS._chain_columns(A.op(), Bt, thr, options)
    else:
        B32 = torch.from_numpy(np.ascontiguousarray(B, dtype=np.float32))
        run = PS._neumann_batch_run if method == "neumann" else PS._cg_batch_run
        X, k, res = run(A.op(batch=True), B32, thr.astype(np.float32),
                        options.max_iterations)
    res = np.asarray(res, dtype=np.float64)
    return X.numpy().astype(np.float64), k, res, res <= thr * 1.0000001


@pytest.mark.parametrize("layout", ["c64", "f64", "c32"])
@pytest.mark.parametrize("method,cols", [("neumann", 128), ("cg", 128),
                                         ("chain", 20)])
def test_device_preparation_equals_host_preparation(layout, method, cols):
    """B uploaded as given (C-ordered float64, the F-ordered view MCP
    ``batchSolve`` passes, float32) and converted on the device: the same
    solutions bit for bit, iterations, residuals and ``converged`` flags as
    the host preparation, in the 128-column Neumann and CG branches and the
    <= 32-column chain branch."""
    A = prep_system("spd" if method == "cg" else "dd")
    rows = np.random.default_rng(cols).uniform(-1, 1, (cols, PREP_N))
    rows *= 10.0 ** np.linspace(-3, 3, cols)[:, None]
    B = {"c64": np.ascontiguousarray(rows.T), "f64": rows.T,
         "c32": np.ascontiguousarray(rows.T, dtype=np.float32)}[layout]
    opts = slp.SolverOptions(epsilon=EPS)
    got = PS.solve_batch(A, B, opts,
                         method="neumann" if method == "chain" else method)
    X, k, res, conv = host_prepared_solve(A, B, method, opts)
    assert got[0].method == ("cg-batch" if method == "cg" else "neumann-batch")
    assert all(conv)
    for j, r in enumerate(got):
        np.testing.assert_array_equal(r.solution, X[:, j])
        assert r.solution.dtype == np.float64
        assert (r.iterations, r.residual, r.converged) == (k, res[j], conv[j])


# ------------------------------------ B staged through a bounded buffer ring

STAGE = 4096  # a chunk small enough that the blocks below take many


@pytest.fixture
def small_chunks(monkeypatch):
    monkeypatch.setattr(PS, "_STAGE_BYTES", STAGE)


def _bits(t):
    """t's bits as integers of its width: equal only where every bit is."""
    return t.view({8: torch.int64, 4: torch.int32}[t.element_size()])


def _stage_block(layout):
    R = np.random.default_rng(9).standard_normal((1000, 24))  # 46.875 chunks
    return {"c64-ragged": lambda: R,
            "c64-exact": lambda: R[:512].copy(),  # 24 chunks
            "f64": lambda: np.asfortranarray(R),
            "f32": lambda: R.astype(np.float32),
            "neg-stride": lambda: R[::-1],
            "gapped": lambda: np.asfortranarray(R)[:, ::2],
            "small": lambda: R[:10]}[layout]()


@pytest.mark.parametrize("layout", ["c64-ragged", "c64-exact", "f64", "f32",
                                    "neg-stride", "gapped", "small"])
def test_staged_upload_walks_every_chunk(small_chunks, layout):
    """``_staged_upload``'s walk over B's memory, run here with plain
    buffers: a copy of B bit for bit, in memory of its own, with the
    strides that ``B.to(device)`` gives (a gapped view laid out densely in
    its own order), whether or not the size is a multiple of the chunk."""
    B = _stage_block(layout)
    src = torch.from_numpy(B if min(B.strides) >= 0
                           else np.ascontiguousarray(B))
    got = PS._staged_upload(src, torch.device("cpu"))
    assert got.stride() == src.to("meta").stride()
    assert got.data_ptr() != src.data_ptr()
    assert torch.equal(_bits(got), _bits(src))


def test_staging_holds_a_bounded_ring(small_chunks, monkeypatch):
    """However large B is, one upload takes ``_STAGE_DEPTH`` buffers of one
    chunk each from the host allocator."""
    B = np.random.default_rng(10).standard_normal((4000, 16))
    assert B.nbytes > 10 * STAGE * PS._STAGE_DEPTH
    taken = []
    empty = torch.empty

    def counting(*args, **kwargs):
        taken.append(args[0])
        return empty(*args, **kwargs)

    monkeypatch.setattr(torch, "empty", counting)
    got = PS._staged_upload(torch.from_numpy(B), torch.device("cpu"))
    monkeypatch.undo()
    assert taken == [STAGE] * PS._STAGE_DEPTH
    assert torch.equal(got, torch.from_numpy(B))


@pytest.mark.parametrize("method,cols", [("neumann", 128), ("cg", 128),
                                         ("chain", 20)])
def test_answers_outlive_a_mutated_rhs(method, cols):
    """B written over after ``solve_batch`` returns changes none of the
    answers it returned."""
    A = prep_system("spd" if method == "cg" else "dd")
    B = np.random.default_rng(cols).uniform(-1, 1, (PREP_N, cols))
    opts = slp.SolverOptions(epsilon=EPS)
    method = "neumann" if method == "chain" else method
    got = PS.solve_batch(A, B, opts, method=method)
    kept = [(r.solution.copy(), r.iterations, r.residual) for r in got]
    want = PS.solve_batch(A, B.copy(), opts, method=method)
    B[:] = np.nan
    for r, w, (x, k, res) in zip(got, want, kept):
        np.testing.assert_array_equal(r.solution, x)
        np.testing.assert_array_equal(r.solution, w.solution)
        assert (r.iterations, r.residual) == (k, res)
