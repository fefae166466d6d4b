"""The Neumann solver's CUDA graphs against its eager path, on the card.

Marked ``cuda``: each test skips when no card is present (decided in the
fixture, not at import).  On a machine with a card and without jax, run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_neumann_graph_cuda.py -q

The eager path is what a call runs while another solve holds the graphs
(``_Replay.lock``), so each comparison is of one matrix, one b and one
chunk length down both paths.  The replays run the same kernels on the same
numbers, so solutions, iterations, residuals and error bounds must be equal
bit for bit, and every counter of a solve must read what the eager path's
does.  This file imports only the port.
"""
import threading
import traceback

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import sublinear_tpu_torch as slp
from sublinear_tpu_torch import tracing
from sublinear_tpu_torch.ops import csr_spmv as K
from sublinear_tpu_torch.solvers import neumann

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda

SIZES = {"headline": (100_000, 1e-4), "20k": (20_000, 5e-4)}


@pytest.fixture(scope="module")
def systems():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = {}
    for name, (n, density) in SIZES.items():
        A = slp.generate("random-sparse", n, seed=7, density=density)
        assert A._op_kind() == "csr"
        B = np.random.default_rng(3).uniform(-1, 1, (4, n))
        out[name] = A, B
    return out


def _replay(A, check_every):
    """The matrix's _Replay after its warm-up solve (eager)."""
    opts = slp.SolverOptions(check_every=check_every)
    slp.solve(A, np.ones(A.shape[0]), opts, method="neumann")
    replay = neumann._replay_for(A, opts)
    assert replay is not None and replay.warm
    return replay


def _solve(A, b, check_every):
    return slp.solve(A, b, method="neumann", check_every=check_every)


def _eager(A, b, check_every, replay):
    with replay.lock:
        return _solve(A, b, check_every)


def _same(got, want):
    assert got.converged and want.converged
    assert got.iterations == want.iterations
    assert got.residual == want.residual
    np.testing.assert_array_equal(got.solution, want.solution)
    assert got.error_bounds == want.error_bounds


@pytest.mark.parametrize("check_every", [5, 3])
@pytest.mark.parametrize("size", sorted(SIZES))
def test_replays_are_bit_equal_to_the_eager_path(systems, size, check_every):
    A, B = systems[size]
    replay = _replay(A, check_every)
    for b in B:
        _same(_solve(A, b, check_every), _eager(A, b, check_every, replay))
    assert replay.graphs is not None


def _counted(fn):
    """(tracing counters, LAUNCHES and STEPS moves) of one call of fn."""
    launches, steps = dict(K.LAUNCHES), dict(K.STEPS)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    counts = tracing.counters()
    tracing.reset()
    moved = {f"launches.{k}": K.LAUNCHES[k] - launches[k] for k in launches}
    moved.update({f"steps.{k}": K.STEPS[k] - steps[k] for k in steps})
    return counts, moved


@pytest.mark.parametrize("check_every", [5, 3])
def test_every_counter_reads_what_the_eager_path_reads(systems, check_every):
    A, B = systems["headline"]
    replay = _replay(A, check_every)
    _solve(A, B[0], check_every)  # captures, if not yet
    eager = _counted(lambda: _eager(A, B[1], check_every, replay))
    graph = _counted(lambda: _solve(A, B[1], check_every))
    chunks = graph[0].pop("neumann_graph_chunks")
    assert chunks == graph[0]["neumann_chain_calls"] >= 1
    assert "neumann_graph_captures" not in graph[0]
    assert graph == eager
    for name in ("host_syncs", "h2d_bytes", "d2h_bytes",
                 "neumann_chain_steps"):
        assert graph[0][name] > 0, name


def test_a_capture_counts_only_the_capture(systems):
    """A capture records kernels without launching them: the solve that
    captures counts what a replaying solve counts, and one capture."""
    n, density = SIZES["20k"]
    A = slp.generate("random-sparse", n, seed=8, density=density)
    b = systems["20k"][1][0]
    replay = _replay(A, 5)
    assert replay.graphs is None
    first = _counted(lambda: _solve(A, b, 5))
    assert first[0].pop("neumann_graph_captures") == 1
    assert first == _counted(lambda: _solve(A, b, 5))


def test_a_second_thread_falls_back_while_the_graphs_are_held(systems):
    A, B = systems["20k"]
    replay = _replay(A, 5)
    want = _solve(A, B[2], 5)
    out = {}

    def other():
        tracing.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            out["result"] = _solve(A, B[2], 5)
        out["counts"] = tracing.counters()

    with replay.lock:  # a first solve holds the graphs
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=120)
    tracing.reset()
    assert not t.is_alive()
    assert out["counts"].get("neumann_graph_chunks", 0) == 0
    assert out["counts"]["neumann_chain_calls"] >= 1
    _same(out["result"], want)


def test_threads_solving_at_once_get_the_same_bits(systems):
    """Threads share one matrix: each solve replays or, finding the graphs
    held, runs eagerly, and every answer equals the lone solve's."""
    A, B = systems["20k"]
    _replay(A, 5)
    wants = [_solve(A, b, 5) for b in B]
    results, errors = [], []

    def worker(seed):
        try:
            for i in np.random.default_rng(seed).integers(0, len(B), 12):
                results.append((int(i), _solve(A, B[i], 5)))
        except Exception as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(results) == 48
    for i, got in results:
        _same(got, wants[i])


def test_two_matrices_capture_at_once(systems):
    """Two threads capture the graphs of two matrices at the same moment
    while a third solves eagerly (with x0) on a third matrix: each capture
    records its own solve only, no thread's work breaks another's, and
    each answer equals the eager path's."""
    n, density = SIZES["20k"]
    B = systems["20k"][1]
    mats = [slp.generate("random-sparse", n, seed=s, density=density)
            for s in (21, 22, 23)]
    replays = [_replay(A, 5) for A in mats[:2]]
    assert all(r.graphs is None for r in replays)
    x0 = np.zeros(n)
    want_eager = slp.solve(mats[2], B[2], method="neumann", x0=x0)
    start, out, errors = threading.Barrier(3), {}, []
    captured = threading.Event()

    def worker(i):
        try:
            start.wait()
            out[i] = _solve(mats[i], B[i], 5)
        except Exception:  # reported below, with where it was raised
            errors.append(traceback.format_exc())

    def eager():
        try:
            start.wait()
            while not captured.is_set():
                got = slp.solve(mats[2], B[2], method="neumann", x0=x0)
                _same(got, want_eager)
        except Exception:
            errors.append(traceback.format_exc())

    threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
    side = threading.Thread(target=eager)
    for t in threads + [side]:
        t.start()
    for t in threads:
        t.join(timeout=120)
    captured.set()
    side.join(timeout=120)
    assert not errors, "\n".join(errors)
    assert not any(t.is_alive() for t in threads + [side])
    for i, (A, replay) in enumerate(zip(mats, replays)):
        assert replay.graphs is not None
        _same(out[i], _eager(A, B[i], 5, replay))
        _same(_solve(A, B[i], 5), out[i])


def test_a_matrix_off_the_current_device():
    """A matrix on a card that is not the current device captures and
    replays on its own card, and answers as the same matrix does on the
    current one."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    n, density = SIZES["20k"]
    other = torch.device("cuda", 1)
    assert torch.cuda.current_device() == 0
    A0 = slp.generate("random-sparse", n, seed=7, density=density)
    A1 = slp.Matrix(A0.csr, device=other)
    B = np.random.default_rng(5).uniform(-1, 1, (3, n))
    replay = _replay(A1, 5)
    assert replay.op.device == other
    wants = [_solve(A0, b, 5) for b in B]
    counts, _ = _counted(lambda: [_solve(A1, b, 5) for b in B])
    assert counts["neumann_graph_chunks"] >= 3
    for b, want in zip(B, wants):
        _same(_solve(A1, b, 5), want)
        _same(_eager(A1, b, 5, replay), want)
    assert torch.cuda.current_device() == 0


def test_a_timeout_solve_replays_its_first_chunk(systems):
    """The timeout path's first chunk has no x0, so the graphs serve it;
    the answer equals the eager path's."""
    A, B = systems["20k"]
    replay = _replay(A, 5)
    _solve(A, B[0], 5)  # captures, if not yet
    opts = slp.SolverOptions(timeout=60.0)
    counts, _ = _counted(lambda: slp.solve(A, B[3], opts, method="neumann"))
    assert counts["neumann_graph_chunks"] >= 1
    with replay.lock:
        want = slp.solve(A, B[3], opts, method="neumann")
    _same(slp.solve(A, B[3], opts, method="neumann"), want)


def test_the_profiler_names_the_replayed_kernels(systems):
    """Kernels inside a replay appear under their own names, so the
    benchmark's readers of neumann_chain_kernel and csr_spmv_kernel still
    read; a solve launches as many kernels replayed as eagerly."""
    A, B = systems["headline"]
    replay = _replay(A, 5)
    _solve(A, B[0], 5)

    def kernels(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        names = [e.name() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == torch.autograd.DeviceType.CUDA
                 and not e.is_user_annotation()
                 and not e.name().lower().startswith(("memcpy", "memset"))
                 and not e.name().startswith(("slt.", "bench."))]
        return names

    graph = kernels(lambda: _solve(A, B[1], 5))
    eager = kernels(lambda: _eager(A, B[1], 5, replay))
    for name in ("neumann_chain_kernel", "csr_spmv_kernel"):
        assert sum(name in k for k in graph) == sum(name in k for k in eager) > 0
    assert len(graph) == len(eager)
