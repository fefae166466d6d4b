"""The SPD headline under CG (``rsparse-100k-spd.cg-stream``): found from
its files, correct at its small size with every answer from CG's chain
path, not correct for the control and for a fault planted in CG, and its
five per-layer readers by hand, with nothing to read where the port lacks
CG's span and counters."""
import json
from pathlib import Path

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from bench_port import control, gen, harness, roofline
from bench_port.trace import REQUEST, WINDOW, DeviceOp, Trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "rsparse-100k-spd.cg-stream"
METRICS = ["cg.host_ms", "cg.loop_host_ms", "cg.syncs", "cg.chunks", "cg_roofline"]


@pytest.fixture(autouse=True)
def fresh_counters():
    from sublinear_tpu_torch import tracing

    tracing.reset()
    yield
    tracing.reset()


@pytest.fixture
def methods(monkeypatch):
    """The method each solve() of the port reports, in call order."""
    import sublinear_tpu_torch

    seen, original = [], sublinear_tpu_torch.solve

    def solve(*a, **kw):
        r = original(*a, **kw)
        seen.append(r.method)
        return r
    monkeypatch.setattr(sublinear_tpu_torch, "solve", solve)
    return seen


def test_the_cell_is_found_from_its_files():
    cell = harness.load_cell(CELL)
    assert cell.config["kind"] == "random-sparse-spd"
    assert gen.kind("random-sparse-spd").__module__.startswith("bench_port_kinds_")
    assert cell.traffic["entry"] == "solve" and cell.traffic["method"] == "cg"
    assert {m["name"] for m in cell.metrics} == {"solutions_per_s", "setup_s",
                                                 *METRICS}
    declared = {m["name"]: m for m in BENCH["per_layer"]}
    for name in METRICS:
        assert declared[name]["workloads"] == [CELL]
        assert declared[name]["moves"] == "solutions_per_s"


@pytest.mark.parametrize("seed", [7, 2**40 + 3])
def test_the_kind_is_symmetric_dominant_and_of_a_fixed_count(seed):
    cfg = harness.load_cell(CELL).config
    cfg = {**cfg, **cfg["small"]}
    d = gen.make(cfg, gen.generator(seed, "cpu"), "cpu")
    n = d.n
    half = round(cfg["density"] * n * (n - 1) / 2)
    assert d.rows.size == 2 * half + n
    off = d.rows != d.cols
    assert np.all(d.rows[:half] < d.cols[:half])
    np.testing.assert_array_equal(d.rows[:half], d.cols[half:2 * half])
    np.testing.assert_array_equal(d.vals[:half], d.vals[half:2 * half])
    row_abs = np.bincount(d.rows[off], weights=np.abs(d.vals[off]), minlength=n)
    diag = np.bincount(d.rows[~off], weights=d.vals[~off], minlength=n)
    np.testing.assert_allclose(diag, 1.5 * row_abs + 1.0)


@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_sound_runs_are_correct_and_every_answer_is_cgs(small_run, methods, seed):
    line = small_run(CELL, seed=seed)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert methods and set(methods) == {"conjugate-gradient"}


def test_the_neumann_control_in_bfloat16_is_not_correct(small_run):
    line = small_run(CELL, impl=control.control)
    assert line["correct"] is False, line["checks"]
    assert line["checks"]["residual_max"]["value"] > 1e-6


def test_an_altered_answer_is_not_correct(small_run, monkeypatch):
    from sublinear_tpu_torch.solvers import cg

    original = cg._cg_chain_run

    def altered(*a, **kw):
        x, *rest = original(*a, **kw)
        x = x.clone()
        x[x.abs().argmax()] *= 2
        return (x, *rest)
    monkeypatch.setattr(cg, "_cg_chain_run", altered)
    line = small_run(CELL)
    assert line["correct"] is False, line["checks"]


def test_a_chain_that_leaves_its_state_unchanged_is_not_correct(small_run,
                                                                monkeypatch):
    from sublinear_tpu_torch.ops import csr_spmv

    def stuck(self, x, r, p, rz, iters):
        return x, r, p, rz, csr_spmv.dot64(r, r)
    monkeypatch.setattr(csr_spmv.CsrOperator, "cg_chain", stuck)
    line = small_run(CELL, seconds=0.1)
    assert line["correct"] is False, line["checks"]
    assert line["checks"]["unconverged"]["value"] > 0


def test_traced_line_reads_cgs_span_and_counters(small_run):
    line = small_run(CELL, traced=True)
    assert line["correct"] is True, line["checks"]
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert m["cg.chunks"] >= 1
    assert m["cg.syncs"] == 2 + m["cg.chunks"]
    assert 0 < m["cg.loop_host_ms"] < m["cg.host_ms"]
    # no device here: no kernel time, so no roofline share, not a 0
    assert "cg_roofline" not in m


def _trace(host_ops):
    """Two requests, 0-4 ms and 5-10 ms; kernels of 1 ms and 2 ms in the
    first and one of 3 ms plus a 1 ms copy in the second."""
    ms = 1_000_000
    spans = {WINDOW: [(0, 10 * ms)], REQUEST: [(0, 4 * ms), (5 * ms, 10 * ms)]}
    ops = [DeviceOp(1 * ms, 2 * ms, "k1", True), DeviceOp(2 * ms, 4 * ms, "k2", True),
           DeviceOp(5 * ms, 8 * ms, "cg_chain_kernel", True),
           DeviceOp(8 * ms, 9 * ms, "Memcpy DtoH", False)]
    host = sorted((int(s * ms), int(e * ms), name) for s, e, name in host_ops)
    return Trace(spans, ops, host)


def _run(trace, iterations=(10, 12)):
    cell = harness.load_cell(CELL)  # trace_warmup 3
    reqs = [harness.Request(0.0, 0.0, 1, 1, [k]) for k in iterations]
    data = gen.Data(100_000, None, None, None, 1_099_990, 100_000)
    return harness.Run(cell, data, 9.5, reqs, 1.0, trace)


SOLVES = [(0.1, 3.9, "slt.solve"), (0.2, 0.4, "slt.to_device"),
          (0.5, 3.0, "slt.loop"), (3.2, 3.6, "slt.to_host"),
          (5.1, 9.9, "slt.solve"), (5.5, 9.0, "slt.loop")]


def test_readers_by_hand():
    run = _run(_trace(SOLVES))
    # slt.solve less the busy inside it: 3.8 - 2.9, 4.8 - 3.9
    assert harness.reader("cg.host_ms")(run) == pytest.approx(0.9)
    # slt.loop less the busy inside it: 2.5 - 2.0, 3.5 - 3.5
    assert harness.reader("cg.loop_host_ms")(run) == pytest.approx(0.25)
    # the counters: 3 warm-up requests and the window's 2
    from sublinear_tpu_torch import tracing

    assert harness.reader("cg.chunks")(run) == 0.0  # the span, no chain
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("host_syncs", 15)
        tracing.count("cg_chain_calls", 5)
    assert harness.reader("cg.syncs")(run) == 3.0
    assert harness.reader("cg.chunks")(run) == 1.0


def test_cg_roofline_bytes_by_hand():
    run = _run(_trace(SOLVES))  # 6 ms of kernels in the requests
    # k + 1 products with the whole matrix: indptr 400,004 bytes, indices
    # and values 8 * 1,099,990, x read and y written 800,000
    product = 400_004 + 8 * 1_099_990 + 800_000
    assert roofline.spmv_bytes(100_000, 1_099_990) == product
    want = 100 * (11 + 13) * product / 3.35e12 / 6e-3
    assert harness.reader("cg_roofline")(run) == pytest.approx(want)
    # memory bound: the operations' time is far below the bytes'
    assert 2 * 24 * 1_099_990 / 67e12 < 24 * product / 3.35e12


def test_nothing_to_read_without_the_new_names():
    # a port whose CG loop records no slt.loop and counts nothing
    from sublinear_tpu_torch import tracing

    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("host_syncs", 5)
    old = _run(_trace([s for s in SOLVES if s[2] != "slt.loop"]))
    for name in ("cg.loop_host_ms", "cg.syncs", "cg.chunks"):
        assert harness.reader(name)(old) is None, name
    # no port spans and no kernels at all
    bare = Trace({WINDOW: [(0, 10)], REQUEST: [(0, 4), (5, 10)]}, [], [])
    for name in METRICS:
        assert harness.reader(name)(_run(bare)) is None, name