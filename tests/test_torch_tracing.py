"""The port's spans and counters (``sublinear_tpu_torch/tracing.py``): off
without a profiler, and under one the spans of ``solve``, ``solve_batch``
and personalized PageRank nested as the benchmark reads them, the copy and
sync counts worked out from the code (on the paths no cell runs too), and
the same answers."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import sublinear_tpu_torch as slp
from sublinear_tpu_torch import config, tracing
from sublinear_tpu_torch.formats.streaming import StreamingOperator
from sublinear_tpu_torch.graph import personalized_pagerank
from sublinear_tpu_torch.graph.social import degroot_consensus
from sublinear_tpu_torch.parallel.sharded import solve_batch
from sublinear_tpu_torch.solvers import bmssp, random_walk
from sublinear_tpu_torch.solvers.refine import solve_refined
from sublinear_tpu_torch.utils import profiling

from torch_parity import dd_coo, port_on_cpu, spd_coo  # noqa: F401

N = 4096  # the smallest size that the sparse kernels' route takes


@pytest.fixture(scope="module")
def system():
    r, c, v = dd_coo(N, seed=11)
    A = slp.Matrix.from_coo(r, c, v, (N, N), prefer="csr")
    b = np.random.default_rng(1).uniform(-1, 1, N)
    B = np.random.default_rng(2).uniform(-1, 1, (N, 40))
    slp.solve(A, b, method="neumann")  # packs the operator once
    solve_batch(A, B, slp.SolverOptions(), method="neumann")
    return A, b, B


def _graph():
    rng = np.random.default_rng(5)
    r, c = rng.integers(0, N, 5 * N), rng.integers(0, N, 5 * N)
    keep = r != c
    # no preference: P^T's operator kind is chosen as the benchmark's is
    return slp.Matrix.from_coo(r[keep], c[keep], np.ones(keep.sum()), (N, N))


@pytest.fixture(scope="module")
def graph():
    return _graph()


def _spans(prof):
    """[(start ns, end ns, name)] of the port's spans, by start."""
    return sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("slt.")
                  and e.device_type() == torch.autograd.DeviceType.CPU)


def _parents(spans):
    """{span name: set of names of the innermost span around it (None at
    the top)}."""
    out = {}
    for i, (s, e, name) in enumerate(spans):
        around = [sp for j, sp in enumerate(spans)
                  if j != i and sp[0] <= s and e <= sp[1]]
        parent = max(around, key=lambda sp: sp[0])[2] if around else None
        out.setdefault(name, set()).add(parent)
    return out


def _traced(fn):
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof), tracing.counters()


def test_off_without_a_profiler(system):
    A, b, _ = system
    assert not tracing.enabled()
    assert tracing.span("slt.solve") is tracing.span("slt.loop")
    tracing.reset()
    tracing.count("host_syncs", 3)
    slp.solve(A, b, method="neumann")
    config.to_device(np.ones(8), torch.float32)
    assert tracing.counters() == {}


def test_the_flag_read_is_the_one_a_profile_sets():
    assert not tracing.enabled()
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.enabled()
        assert not isinstance(tracing.span("slt.x"), type(tracing._NO_SPAN))
    assert not tracing.enabled()


def test_solve_spans_and_syncs(system):
    A, b, _ = system
    r, spans, counts = _traced(lambda: slp.solve(A, b, method="neumann"))
    names = [name for _, _, name in spans]
    assert sorted(names) == sorted(["slt.solve", "slt.to_device", "slt.loop",
                                    "slt.to_host"])
    assert _parents(spans) == {"slt.solve": {None},
                               "slt.to_device": {"slt.solve"},
                               "slt.loop": {"slt.solve"},
                               "slt.to_host": {"slt.solve"}}
    chunks = r.iterations // slp.SolverOptions().check_every
    assert chunks >= 2
    # the initial residual with b's float64 norm (the threshold), one per
    # chunk, the two tail norms, x
    assert counts["host_syncs"] == 1 + chunks + 2 + 1
    assert counts["h2d_bytes"] == N * 8  # b in float64
    assert counts["d2h_bytes"] == 2 * 8 + (chunks + 2) * 4 + N * 4


def test_neumann_chain_calls_and_steps(system):
    A, b, _ = system
    r, _, counts = _traced(lambda: slp.solve(A, b, method="neumann"))
    check = slp.SolverOptions().check_every
    chunks = r.iterations // check
    assert chunks >= 2
    assert counts["neumann_chain_calls"] == chunks
    assert counts["neumann_chain_steps"] == chunks * check


@pytest.mark.parametrize("traced", [True, False],
                         ids=["check_every_1", "no_profiler"])
def test_neumann_chain_counts_nothing_off_its_path(system, traced):
    """The per-step loop (``check_every=1``) runs no chain, and without a
    profiler nothing is counted."""
    A, b, _ = system
    if traced:
        r, _, counts = _traced(
            lambda: slp.solve(A, b, method="neumann", check_every=1))
        assert r.iterations >= 2 and counts["host_syncs"] >= 2
    else:
        tracing.reset()
        slp.solve(A, b, method="neumann")
        counts = tracing.counters()
    assert counts.get("neumann_chain_calls", 0) == 0
    assert counts.get("neumann_chain_steps", 0) == 0


@pytest.mark.parametrize("mode", ["l2", "l1", "max"])
def test_threshold_rides_on_the_first_read(system, mode):
    """``prepare``'s threshold waits on the device as b's float64 norm and
    comes up beside the first residual: one read of 16 bytes for both, and
    the number the host norm gives to 1e-14."""
    from sublinear_tpu_torch.solvers import base

    A, b, _ = system
    opts = slp.SolverOptions(convergence_mode=mode)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        _, b_dev, _, thr = base.prepare(A, b, opts)
        assert isinstance(thr, base.Threshold) and thr.value is None
        res, lims = base.first_check(torch.linalg.vector_norm(b_dev), thr)
    counts = tracing.counters()
    assert counts["host_syncs"] == 1 and counts["d2h_bytes"] == 16
    want = base.threshold_for(b, opts)
    assert abs(float(thr) - want) <= 1e-14 * want
    assert lims[0] == base.limits(torch.float32, want)[0]
    assert res == float(torch.linalg.vector_norm(b_dev))


def test_threshold_read_alone_and_absolute(system):
    """A ``Threshold`` that no loop has read reads its norm once on
    ``float()``; absolute convergence needs no norm at all."""
    from sublinear_tpu_torch.solvers import base

    A, b, _ = system
    _, _, _, thr = base.prepare(A, b, slp.SolverOptions())
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        first = float(thr)
        again = float(thr)
    assert first == again
    assert tracing.counters() == {"host_syncs": 1, "d2h_bytes": 8}
    absolute = slp.SolverOptions(convergence="absolute", epsilon=1e-7)
    assert base.prepare(A, b, absolute)[3] == 1e-7


def test_solve_batch_spans_and_copies(system):
    A, _, B = system
    results, spans, counts = _traced(
        lambda: solve_batch(A, B, slp.SolverOptions(), method="neumann"))
    assert _parents(spans) == {"slt.solve_batch": {None},
                               "slt.to_device": {"slt.solve_batch"},
                               "slt.loop": {"slt.solve_batch"},
                               "slt.to_host": {"slt.solve_batch"}}
    k, cols = results[0].iterations, B.shape[1]
    # B's float64 column norms, k - 1 loop reads of the column norms, the
    # final ones, and X widened to float64 on the device
    assert counts["host_syncs"] == k + 2
    assert counts["h2d_bytes"] == B.size * 8  # B as the caller gave it
    assert counts["d2h_bytes"] == k * cols * 4 + cols * 8 + B.size * 8
    assert "pinned_d2h_bytes" not in counts  # no pinned copy on the CPU


def test_solve_batch_stages_nothing_on_the_cpu(system, monkeypatch):
    """On the CPU, B is never staged, however many chunks it spans: no
    ``pinned_h2d_bytes``, and ``h2d_bytes`` counts B as given."""
    from sublinear_tpu_torch.parallel import sharded

    A, _, B = system
    monkeypatch.setattr(sharded, "_STAGE_BYTES", 4096)
    assert B.nbytes > 10 * sharded._STAGE_BYTES
    _, _, counts = _traced(
        lambda: solve_batch(A, B, slp.SolverOptions(), method="neumann"))
    assert counts["h2d_bytes"] == B.nbytes
    assert "pinned_h2d_bytes" not in counts


# the spans of P^T's build, which a graph's first PageRank call makes
TRANSITION_SPANS = ("slt.pagerank.transition", "slt.matrix.from_coo",
                    "slt.matrix.dia_probe", "slt.matrix.pack",
                    "slt.csr.row_blocks")


def test_pagerank_spans():
    graph = _graph()  # a fresh graph: its first call builds P^T
    _, spans, counts = _traced(
        lambda: personalized_pagerank(graph, [3]))
    parents = _parents(spans)
    assert parents["slt.pagerank.inputs"] == {None}
    assert parents["slt.pagerank.transition"] == {"slt.pagerank.inputs"}
    assert parents["slt.matrix.from_coo"] == {"slt.pagerank.transition"}
    assert parents["slt.matrix.dia_probe"] == {"slt.pagerank.inputs"}
    assert parents["slt.matrix.pack"] == {"slt.pagerank.inputs"}
    assert parents["slt.to_device"] == {"slt.matrix.pack",
                                        "slt.pagerank.inputs"}
    assert parents["slt.pagerank.run"] == {None}
    assert parents["slt.loop"] == {"slt.pagerank.run"}
    assert parents["slt.to_host"] == {None}  # the scores
    assert counts["host_syncs"] >= 3
    assert counts["pagerank_transition_builds"] == 1
    assert "pagerank_transition_hits" not in counts


def test_pagerank_spans_on_a_hit():
    graph = _graph()
    first = personalized_pagerank(graph, [3])
    again, spans, counts = _traced(lambda: personalized_pagerank(graph, [3]))
    names = {name for _, _, name in spans}
    assert names.isdisjoint(TRANSITION_SPANS), names
    assert _parents(spans)["slt.to_device"] == {"slt.pagerank.inputs"}  # v
    assert counts["pagerank_transition_hits"] == 1
    assert "pagerank_transition_builds" not in counts
    np.testing.assert_array_equal(again.scores, first.scores)


def test_row_blocks_span(graph):
    op = graph.op()
    op._row_blocks = None
    blocks, spans, counts = _traced(lambda: op.row_blocks)
    assert _parents(spans) == {"slt.csr.row_blocks": {None},
                               "slt.to_host": {"slt.csr.row_blocks"},
                               "slt.to_device": {"slt.csr.row_blocks"}}
    assert counts == {"host_syncs": 1, "d2h_bytes": (N + 1) * 4,
                      "h2d_bytes": blocks.numel() * 4}


def test_transfer_counters_by_hand():
    def run():
        t = config.to_device(np.arange(1000), torch.float64)
        h = config.to_host(t[:10], np.float32)
        return t, h, config.host_float(t[3])
    (t, h, x), _, counts = _traced(run)
    assert t.dtype == torch.float64 and h.dtype == np.float32 and x == 3.0
    assert counts == {"h2d_bytes": 8000, "d2h_bytes": 80 + 8,
                      "host_syncs": 2}


def test_answers_are_bit_equal_traced_and_not(system, graph):
    A, b, B = system
    calls = [lambda: slp.solve(A, b, method="neumann").solution,
             lambda: np.column_stack([r.solution for r in solve_batch(
                 A, B, slp.SolverOptions(), method="neumann")]),
             lambda: personalized_pagerank(graph, [7]).scores]
    for call in calls:
        plain = call()
        traced, spans, _ = _traced(call)
        assert spans
        np.testing.assert_array_equal(traced, plain)


def test_device_trace_writes_the_counters(system, tmp_path):
    A, b, _ = system
    tracing.count("host_syncs")  # not recording: nothing to carry over
    with profiling.device_trace(str(tmp_path / "t")) as tr:
        r = slp.solve(A, b, method="neumann")
    saved = json.loads(Path(tr.counters_path).read_text())
    assert saved == tr.counters
    chunks = r.iterations // slp.SolverOptions().check_every
    assert saved["host_syncs"] == 1 + chunks + 2 + 1
    doc = json.loads(Path(tr.path).read_text())
    assert "slt.solve" in {e.get("name") for e in doc["traceEvents"]}


@pytest.fixture(scope="module")
def spd_system():
    r, c, v = spd_coo(N, seed=13)
    A = slp.Matrix.from_coo(r, c, v, (N, N), prefer="csr")
    b = np.random.default_rng(3).uniform(-1, 1, N)
    slp.solve(A, b, method="cg")  # packs the operator, analyzes A once
    return A, b


def _chunks(iterations, check_every):
    """The chain's chunks for ``iterations``: a head of 2 * check_every
    steps, then chunks of max(2, check_every // 2)."""
    head, tail = 2 * check_every, max(2, check_every // 2)
    return 1 + -(-max(0, iterations - head) // tail)


def test_cg_chain_spans_syncs_and_chunks(spd_system):
    A, b = spd_system
    r, spans, counts = _traced(lambda: slp.solve(A, b, method="cg"))
    assert r.method == "conjugate-gradient"
    assert _parents(spans) == {"slt.solve": {None},
                               "slt.to_device": {"slt.solve"},
                               "slt.loop": {"slt.solve"},
                               "slt.to_host": {"slt.solve"}}
    chunks = _chunks(r.iterations, slp.SolverOptions().check_every)
    assert chunks >= 1
    assert counts["cg_chain_calls"] == chunks
    # the initial residual with b's norm, ||r||^2 once per chunk, x
    assert counts["host_syncs"] == 1 + chunks + 1
    assert counts["d2h_bytes"] == 2 * 8 + chunks * 4 + N * 4


@pytest.mark.parametrize("method,options", [("cg", {"check_every": 1}),
                                            ("bicgstab", {})])
def test_per_step_krylov_loops_count_one_read_a_step(spd_system, method,
                                                     options):
    A, b = spd_system
    r, spans, counts = _traced(
        lambda: slp.solve(A, b, method=method, **options))
    assert r.method == {"cg": "conjugate-gradient"}.get(method, method)
    assert _parents(spans)["slt.loop"] == {"slt.solve"}
    k = r.iterations
    assert k >= 2 and "cg_chain_calls" not in counts
    # the initial residual with b's norm, (residual, change) once per
    # step, x
    assert counts["host_syncs"] == 1 + k + 1
    assert counts["d2h_bytes"] == 2 * 8 + k * 2 * 4 + N * 4


@pytest.mark.parametrize("method,options", [("cg", {}), ("cg", {"check_every": 1}),
                                            ("bicgstab", {})])
def test_krylov_answers_are_bit_equal_traced_and_not(spd_system, method,
                                                     options):
    A, b = spd_system
    plain = slp.solve(A, b, method=method, **options)
    traced, spans, _ = _traced(
        lambda: slp.solve(A, b, method=method, **options))
    assert "slt.loop" in {name for _, _, name in spans}
    assert traced.iterations == plain.iterations
    assert traced.residual == plain.residual
    np.testing.assert_array_equal(traced.solution, plain.solution)


# ------------------------------------------------ the reads of other paths

SMALL = 240  # the dense route: no row-block partition is read back
CHECK = slp.SolverOptions().check_every


@pytest.fixture(scope="module")
def small():
    A = slp.Matrix.from_coo(*dd_coo(SMALL, seed=17), (SMALL, SMALL))
    b = np.random.default_rng(4).uniform(-1, 1, SMALL)
    slp.solve(A, b, method="neumann")  # packs the operator, analyzes A
    return A, b


def _degroot(A, b):
    out, _, counts = _traced(lambda: degroot_consensus(A, b, steps=10))
    assert len(out["opinions"]) == SMALL
    return counts, 1, SMALL * 4  # the opinions


def _streaming(A, b):
    S = StreamingOperator(A.csr, panel_budget=1, device=A.device)
    assert S.n_panels == 2
    y, _, counts = _traced(lambda: S.matvec(b))
    np.testing.assert_allclose(y, A.csr.matvec(b), rtol=1e-5, atol=1e-5)
    return counts, 1, SMALL * 4  # y, in float32


def _refined(A, b):
    r, spans, counts = _traced(lambda: solve_refined(
        A, b, slp.SolverOptions(epsilon=1e-10), method="neumann",
        raise_on_fail=False))
    solves = [name for _, _, name in spans].count("slt.solve")
    assert solves >= 2
    # on the CPU the residuals are host products; each inner Neumann solve
    # reads its initial residual with b's float64 norm, one residual a
    # chunk, two tail norms, x
    chunks = r.iterations // CHECK
    return (counts, 4 * solves + chunks,
            (2 * 8 + (2 + SMALL) * 4) * solves + 4 * chunks)


def _push(A, b):
    r, _, counts = _traced(lambda: slp.solve(
        A, b, method="forward-push", raise_on_fail=False))
    chunks = r.iterations // CHECK
    assert chunks >= 2
    # the initial residual with b's float64 norm, one a chunk, x
    return counts, 1 + chunks + 1, 2 * 8 + chunks * 4 + SMALL * 4


def _random_walk(A, b):
    walks = 16
    r, _, counts = _traced(lambda: slp.solve(
        A, b, method="random-walk", num_walks=walks, raise_on_fail=False))
    max_len = min(slp.SolverOptions().max_walk_length, 512)
    blocks = -(-r.iterations // random_walk.WALK_BLOCK)
    assert 2 <= blocks < max_len // random_walk.WALK_BLOCK
    # the alive flag (a bool) after each block, the step count (int64), the
    # walkers' sums (one chunk of SMALL * walks walkers)
    return counts, blocks + 2, blocks + 8 + SMALL * walks * 4


def _bmssp(A, b):
    e = np.zeros(SMALL)
    e[5] = 1.0
    r, _, counts = _traced(lambda: slp.solve(A, e, method="bmssp",
                                             raise_on_fail=False))
    assert r.method == "bmssp"
    blocks = -(-r.iterations // bmssp.SWEEP_BLOCK)
    # the changed flag (a bool) after each block, the sweep count (int64),
    # the distances and x
    return counts, blocks + 3, blocks + 8 + 2 * SMALL * 4


READ_PATHS = {"degroot_consensus": _degroot, "streaming_matvec": _streaming,
              "solve_refined": _refined, "forward-push": _push,
              "random-walk": _random_walk, "bmssp": _bmssp}


@pytest.mark.parametrize("path", sorted(READ_PATHS))
def test_every_read_of_a_path_is_counted(small, path):
    """``host_syncs`` and ``d2h_bytes`` count each blocking read that the
    path makes, worked out from its code."""
    counts, syncs, nbytes = READ_PATHS[path](*small)
    assert counts.get("host_syncs", 0) == syncs
    assert counts.get("d2h_bytes", 0) == nbytes
