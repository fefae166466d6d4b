"""The readers of the port's own spans and counters (``program.py``): the
per-request and self-time arithmetic by hand, the counters over the
profiled requests, nothing to read from a port without them, and a traced
run of each cell that reports every one."""
import json
import sys
from pathlib import Path

import pytest
from torch.profiler import ProfilerActivity, profile

from bench_port import gen, harness, program
from bench_port.trace import REQUEST, WINDOW, DeviceOp, Trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = {"rsparse-100k.stream": ["solve.self_ms", "solve.loop_host_ms",
                               "solve.copy_ms", "solve.syncs"],
       "rsparse-100k.batch128": ["batch.self_ms", "batch.copy_ms",
                                 "batch.copy_mb"],
       "webgraph-rmat-1m.ppr": ["ppr.transition_ms", "ppr.from_coo_ms",
                                "ppr.pack_ms", "ppr.row_blocks_ms",
                                "ppr.dia_probe_ms"]}


@pytest.fixture(autouse=True)
def fresh_counters():
    from sublinear_tpu_torch import tracing

    tracing.reset()
    yield
    tracing.reset()


def _trace(host_ops):
    """The window of test_selfcheck's fake trace (two requests, 0-4 ms and
    5-10 ms; device busy 1-4 ms and 5-9 ms) with ``host_ops`` in ms."""
    ms = 1_000_000
    spans = {WINDOW: [(0, 10 * ms)], REQUEST: [(0, 4 * ms), (5 * ms, 10 * ms)]}
    ops = [DeviceOp(1 * ms, 2 * ms, "k1", True), DeviceOp(2 * ms, 4 * ms, "k2", True),
           DeviceOp(5 * ms, 8 * ms, "k1", True), DeviceOp(8 * ms, 9 * ms, "Memcpy DtoH", False)]
    host = sorted((int(s * ms), int(e * ms), name) for s, e, name in host_ops)
    return Trace(spans, ops, host)


def _run(trace, requests=2):
    cell = harness.load_cell("rsparse-100k.stream")  # trace_warmup 3
    reqs = [harness.Request(0.0, 0.0, 1, 1, [10]) for _ in range(requests)]
    return harness.Run(cell, gen.Data(10, None, None, None, 10, 10), 1.0, reqs,
                       1.0, trace)


SOLVES = [(0.1, 3.9, "slt.solve"), (0.2, 0.4, "slt.to_device"),
          (0.5, 3.0, "slt.loop"), (0.6, 0.7, "aten::copy_"),
          (3.2, 3.6, "slt.to_host"),
          (5.1, 9.9, "slt.solve"), (5.5, 9.0, "slt.loop"),
          (10.5, 11.0, "slt.solve")]  # after the window: no request's


def test_span_arithmetic_by_hand():
    run = _run(_trace(SOLVES))
    spans = program.request_spans(run.trace)
    assert [[name for _, _, name in r] for r in spans] == [
        ["slt.solve", "slt.to_device", "slt.loop", "slt.to_host"],
        ["slt.solve", "slt.loop"]]
    # self: 3.8 less 0.2 + 2.5 + 0.4, then 4.8 less 3.5
    assert program.self_ns(spans[0], 0) == pytest.approx(0.7e6)
    assert harness.reader("solve.self_ms")(run) == pytest.approx((0.7 + 1.3) / 2)
    # the loops less the device busy inside them: 2.5 - 2.0, 3.5 - 3.5
    assert harness.reader("solve.loop_host_ms")(run) == pytest.approx(0.25)
    # 0.2 + 0.4 in the first request, none in the second
    assert harness.reader("solve.copy_ms")(run) == pytest.approx(0.3)
    assert harness.reader("batch.copy_ms")(run) == pytest.approx(0.3)
    # a request with spans but not the one asked for reads 0
    assert harness.reader("ppr.row_blocks_ms")(run) == 0.0


def test_self_time_counts_an_overlap_of_children_once():
    trace = _trace([(5.0, 9.0, "slt.pagerank.transition"),
                    (5.5, 7.0, "slt.matrix.from_coo"),
                    (6.0, 6.5, "slt.to_device"),
                    (8.0, 8.5, "slt.to_device")])
    run = _run(trace)
    # 4.0 less 1.5 and 0.5; the first request holds none of it
    assert harness.reader("ppr.transition_ms")(run) == pytest.approx(2.0 / 2)
    assert harness.reader("ppr.from_coo_ms")(run) == pytest.approx(1.5 / 2)


def test_nothing_to_read_without_the_ports_spans():
    run = _run(_trace([(0.6, 0.7, "aten::copy_")]))
    for names in NEW.values():
        for name in names:
            if "syncs" not in name and "copy_mb" not in name:
                assert harness.reader(name)(run) is None, name


def test_counters_per_profiled_request():
    from sublinear_tpu_torch import tracing

    run = _run(_trace(SOLVES))
    assert harness.reader("solve.syncs")(run) is None  # never counted
    tracing.count("host_syncs", 99)  # no profiler: not counted
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("host_syncs", 30)
        tracing.count("h2d_bytes", 2_000_000)
        tracing.count("d2h_bytes", 500_000)
    # 3 warm-up requests and the window's 2
    assert harness.reader("solve.syncs")(run) == 6.0
    assert harness.reader("batch.copy_mb")(run) == pytest.approx(2.5 / 5)


def test_counters_of_a_port_without_tracing(monkeypatch):
    monkeypatch.setitem(sys.modules, "sublinear_tpu_torch.tracing", None)
    run = _run(_trace(SOLVES))
    assert harness.reader("solve.syncs")(run) is None
    assert harness.reader("batch.copy_mb")(run) is None


def test_new_metrics_are_declared_for_their_cells():
    declared = {m["name"]: m for m in BENCH["per_layer"]}
    for cell, names in NEW.items():
        for name in names:
            assert declared[name]["workloads"] == [cell]
            assert (ROOT / "bench_port" / "metrics" / f"{name}.py").is_file()


@pytest.mark.parametrize("name", sorted(NEW))
def test_traced_line_reads_the_spans_inside_the_port(small_run, name):
    line = small_run(name, traced=True)
    assert line["correct"] is True, line["checks"]
    for metric in NEW[name]:
        value = line["metrics"][metric]["value"]
        assert value is not None and value >= 0, metric
    # the metrics read from the benchmark's own spans are still there
    old = {"rsparse-100k.stream": "solve.host_ms",
           "rsparse-100k.batch128": "batch.host_ms",
           "webgraph-rmat-1m.ppr": "ppr.setup_ms"}[name]
    assert old in line["metrics"]
    m = line["metrics"]
    if name == "rsparse-100k.stream":
        # at least the initial residual, one chunk, two tail norms and x
        assert m["solve.syncs"]["value"] >= 5
        assert 0 < m["solve.self_ms"]["value"] < m["solve.host_ms"]["value"]
    if name == "rsparse-100k.batch128":
        # B up and X down at the small size, float32: 8 bytes an entry
        n = harness.load_cell(name).config["small"]["n"]
        assert m["batch.copy_mb"]["value"] >= 8 * n * 128 / 1e6
    if name == "webgraph-rmat-1m.ppr":
        assert m["ppr.row_blocks_ms"]["value"] == 0.0  # no kernel here
        assert m["ppr.from_coo_ms"]["value"] < m["ppr.setup_ms"]["value"]
