"""When ``solve_neumann`` replays its CUDA graphs (``solvers/neumann.py``).

No graph runs on the CPU, so the card is stood in for: ``_on_card`` is made
to say yes and ``_Replay`` is replaced by ``FakeReplay``, whose ``solve``
raises ``Replayed``.  A call the graphs serve then raises; a call they do
not serve answers from the eager path, makes no ``_Replay`` and counts no
``neumann_graph_chunks``.  The CPU case keeps the real ``_on_card``.  The
replays themselves are held to the eager path on the card
(``test_torch_neumann_graph_cuda.py``)."""
import threading

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

import sublinear_tpu_torch as slp
from sublinear_tpu_torch import tracing
from sublinear_tpu_torch.parallel.sharded import solve_batch
from sublinear_tpu_torch.solvers import neumann
from sublinear_tpu_torch.solvers.prepared import PreparedSolver
from sublinear_tpu_torch.types import ConvergenceMode

from torch_parity import dd_coo, port_on_cpu  # noqa: F401

N = 4096  # the smallest size that the sparse kernels' route takes


class Replayed(Exception):
    pass


class FakeReplay:
    made: list = []
    warm = True

    def __init__(self, op, check_every):
        self.lock = threading.Lock()
        FakeReplay.made.append(check_every)

    def solve(self, matrix, b, options, raise_on_fail):
        raise Replayed


@pytest.fixture
def card(monkeypatch):
    """The CUDA check says yes, and ``_Replay`` is ``FakeReplay``."""
    FakeReplay.made = []
    monkeypatch.setattr(neumann, "_Replay", FakeReplay)
    monkeypatch.setattr(neumann, "_on_card", lambda op: True)


@pytest.fixture(scope="module")
def system():
    r, c, v = dd_coo(N, seed=11)
    A = slp.Matrix.from_coo(r, c, v, (N, N), prefer="csr")
    b = np.random.default_rng(1).uniform(-1, 1, N)
    return A, b


def _banded(kind):
    d = np.full(N, 4.0)
    if kind == "dia":
        i = np.arange(N - 1)
        return slp.Matrix.from_coo(np.r_[np.arange(N), i, i + 1],
                                   np.r_[np.arange(N), i + 1, i],
                                   np.r_[d, -np.ones(2 * (N - 1))], (N, N))
    r, c, v = dd_coo(N, seed=11)
    return slp.Matrix.from_coo(r, c, v, (N, N), prefer="dense")


def _neumann(**kw):
    return lambda A, b: slp.solve(A, b, method="neumann", **kw)


EAGER = {
    "x0": _neumann(x0=np.zeros(N)),
    "relative_change": _neumann(convergence_mode=ConvergenceMode.RELATIVE_CHANGE),
    "combined": _neumann(convergence_mode=ConvergenceMode.COMBINED),
    "l1": _neumann(convergence_mode=ConvergenceMode.L1_RESIDUAL),
    "max": _neumann(convergence_mode=ConvergenceMode.MAX_RESIDUAL),
    "absolute": _neumann(convergence="absolute", epsilon=1e-4),
    "one_step_chunks": _neumann(check_every=1),
    "dia": lambda A, b: slp.solve(_banded("dia"), b, method="neumann"),
    "dense": lambda A, b: slp.solve(_banded("dense"), b, method="neumann"),
    "prepared": lambda A, b: PreparedSolver(A, "neumann").solve(b),
    "solve_batch": lambda A, b: solve_batch(
        A, np.stack([b, -b], axis=1), slp.SolverOptions(), method="neumann")[0],
    "cpu": _neumann(),
}


@pytest.mark.parametrize("case", sorted(EAGER))
def test_calls_the_graphs_do_not_serve_run_eagerly(system, card, monkeypatch,
                                                   case):
    if case == "cpu":
        monkeypatch.setattr(neumann, "_on_card", lambda op: op.device.type == "cuda")
    A, b = system
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        r = EAGER[case](A, b)
    counts = tracing.counters()
    tracing.reset()
    assert r.converged and r.iterations > 0
    assert FakeReplay.made == []
    assert counts.get("neumann_graph_chunks", 0) == 0
    assert counts.get("neumann_graph_captures", 0) == 0
    # the change-based modes and the other norms still run the chain
    chained = case not in ("one_step_chunks", "dia", "dense")
    assert bool(counts.get("neumann_chain_calls")) == chained


# the timeout path's first chunk has no x0 (its warm restarts have one)
SERVED = {"default": {}, "timeout": {"timeout": 60.0}}


@pytest.mark.parametrize("check_every", [5, 3])
@pytest.mark.parametrize("case", sorted(SERVED))
def test_a_default_solve_replays(system, card, case, check_every):
    A, b = system
    for _ in range(2):
        with pytest.raises(Replayed):
            slp.solve(A, b, method="neumann", check_every=check_every,
                      **SERVED[case])
    # one _Replay per (dtype, chunk length), kept on the matrix
    assert FakeReplay.made == [check_every]
    assert set(A._neumann_graphs) == {("torch.float32", check_every)}
    A._neumann_graphs.clear()


def test_first_solve_is_eager_and_warms(system, card, monkeypatch):
    """An operator's first eligible solve runs eagerly with the lock held,
    then marks the _Replay warm; the next replays."""
    A, b = system
    monkeypatch.setattr(FakeReplay, "warm", False)
    want = neumann._solve_eager(A, b, slp.SolverOptions(), True)
    got = slp.solve(A, b, method="neumann")
    replay, = A._neumann_graphs.values()
    assert replay.warm and not replay.lock.locked()
    np.testing.assert_array_equal(got.solution, want.solution)
    with pytest.raises(Replayed):
        slp.solve(A, b, method="neumann")
    A._neumann_graphs.clear()


def test_a_held_replay_falls_back_without_waiting(system, card):
    """A call that finds the graphs held by another solve runs eagerly."""
    A, b = system
    with pytest.raises(Replayed):
        slp.solve(A, b, method="neumann")
    replay, = A._neumann_graphs.values()
    with replay.lock:
        got = slp.solve(A, b, method="neumann")
    want = neumann._solve_eager(A, b, slp.SolverOptions(), True)
    np.testing.assert_array_equal(got.solution, want.solution)
    assert got.iterations == want.iterations
    A._neumann_graphs.clear()


def test_the_graph_paths_crossings_are_counted():
    """``copy_to_device`` fills a tensor already on the device and counts
    its bytes."""
    import torch

    from sublinear_tpu_torch import config

    out = torch.zeros(5, dtype=torch.float64)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got = config.copy_to_device(np.arange(5, dtype=np.float32), out)
    counts = tracing.counters()
    tracing.reset()
    assert got is out and out.tolist() == [0.0, 1.0, 2.0, 3.0, 4.0]
    assert counts == {"h2d_bytes": 40}
    with pytest.raises(RuntimeError):
        config.copy_to_device(np.zeros(4), out)


def test_a_recording_lists_what_a_replay_counts():
    """Inside ``recording()`` this thread's launches are listed and counted
    nowhere, while another thread's count as usual; ``replayed`` counts the
    list as the wrappers would have counted the launches."""
    from sublinear_tpu_torch.ops import csr_spmv as K

    before = dict(K.LAUNCHES), dict(K.STEPS)
    other = threading.Thread(target=K._launched, args=("csr_spmv",))
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with K.recording() as log:
            K._launched("csr_spmv")
            K._launched("neumann_step", 5)
            other.start()
            other.join()
        assert log == [("csr_spmv", 0), ("neumann_step", 5)]
        assert K.LAUNCHES["csr_spmv"] == before[0]["csr_spmv"] + 1
        assert K.LAUNCHES["neumann_step"] == before[0]["neumann_step"]
        assert tracing.counters() == {}
        for _ in range(2):
            K.replayed(log)
    counts = tracing.counters()
    tracing.reset()
    assert K.LAUNCHES["csr_spmv"] == before[0]["csr_spmv"] + 3
    assert K.LAUNCHES["neumann_step"] == before[0]["neumann_step"] + 2
    assert K.STEPS["neumann_step"] == before[1]["neumann_step"] + 10
    assert counts == {"neumann_chain_calls": 2, "neumann_chain_steps": 10}
