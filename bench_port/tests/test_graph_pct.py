"""``solve.graph_pct``: 100 replayed / all Neumann chains, from the port's
counters over the profiled requests; nothing to read from a port without
the graph counter (the port before its CUDA graphs, or one that never
replayed, as on the CPU) or without ``tracing``, or where no chain ran."""
import json
import sys
from pathlib import Path

import pytest
from torch.profiler import ProfilerActivity, profile

from bench_port import gen, harness

ROOT = Path(__file__).resolve().parents[2]
STREAMS = ["rsparse-100k.stream"]


@pytest.fixture(autouse=True)
def fresh_counters():
    from sublinear_tpu_torch import tracing

    tracing.reset()
    yield
    tracing.reset()


def _run(requests=2):
    cell = harness.load_cell("rsparse-100k.stream")  # trace_warmup 3
    reqs = [harness.Request(0.0, 0.0, 1, 1, [10]) for _ in range(requests)]
    return harness.Run(cell, gen.Data(10, None, None, None, 10, 10), 1.0, reqs,
                       1.0, None)


def _count(**counts):
    from sublinear_tpu_torch import tracing

    with profile(activities=[ProfilerActivity.CPU]):
        for name, n in counts.items():
            tracing.count(name, n)


@pytest.mark.parametrize("counts,want", [
    ({}, None),
    ({"neumann_chain_calls": 10}, None),  # a port without the graphs
    ({"neumann_graph_chunks": 10, "neumann_chain_calls": 0}, None),
    ({"neumann_graph_chunks": 10, "neumann_chain_calls": 10}, 100.0),
    ({"neumann_graph_chunks": 9, "neumann_chain_calls": 12}, 75.0),
])
def test_replayed_share(counts, want):
    _count(**counts)
    assert harness.reader("solve.graph_pct")(_run()) == want


def test_a_port_without_tracing(monkeypatch):
    import sublinear_tpu_torch

    _count(neumann_graph_chunks=10, neumann_chain_calls=10)
    monkeypatch.delattr(sublinear_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "sublinear_tpu_torch.tracing", None)
    assert harness.reader("solve.graph_pct")(_run()) is None


def test_declared_for_the_stream_cell():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    metric, = (m for m in bench["per_layer"] if m["name"] == "solve.graph_pct")
    assert metric["workloads"] == STREAMS
    assert metric["moves"] == "solutions_per_s" and metric["unit"] == "%"
    for cell in STREAMS:
        assert any(m["name"] == "solve.graph_pct"
                   for m in harness.load_cell(cell).metrics)


def test_a_traced_cpu_run_has_nothing_to_read(small_run):
    """On the CPU no graph replays: the line leaves the metric out and
    still holds the stream's other counters."""
    line = small_run("rsparse-100k.stream", traced=True)
    assert line["correct"] is True, line["checks"]
    assert "solve.graph_pct" not in line["metrics"]
    assert line["metrics"]["solve.syncs"]["value"] >= 5
