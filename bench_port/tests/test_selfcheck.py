"""Generators, roofline bytes, rates and spreads, the result line, and the
refusal to run without a card."""
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_port import gen, harness, roofline, stats
from bench_port.trace import REQUEST, WINDOW, DeviceOp, Trace
from conftest import small

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
CONFIGS = sorted(c["name"] for c in BENCH["configs"])


def _data(config_name, seed):
    cfg = small(json.loads(
        (ROOT / "bench_port" / "configs" / f"{config_name}.json").read_text()))
    return gen.make(cfg, gen.generator(seed, "cpu"), "cpu"), cfg


@pytest.mark.parametrize("config_name", CONFIGS)
def test_generator_is_deterministic_per_seed(config_name):
    seed = 2**40 + 3  # more than 32 bits
    a, cfg = _data(config_name, seed)
    b, _ = _data(config_name, seed)
    c, _ = _data(config_name, seed + 1)
    for field in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert not np.array_equal(a.cols, c.cols)
    assert (a.nnz, a.nnz_diag) == (b.nnz, b.nnz_diag)
    # every seed does the same work: the same number of entries
    assert a.rows.size == c.rows.size
    keys = np.unique(a.rows * a.n + a.cols)
    assert a.nnz == keys.size
    assert a.nnz_diag == int(np.sum(keys // a.n == keys % a.n))


def test_random_sparse_is_diagonally_dominant():
    d, cfg = _data("rsparse-100k", 5)
    n = d.n
    assert d.rows.size == round(cfg["density"] * n * (n - 1)) + n
    off = d.rows != d.cols
    row_abs = np.bincount(d.rows[off], weights=np.abs(d.vals[off]), minlength=n)
    diag = np.bincount(d.rows[~off], weights=d.vals[~off], minlength=n)
    np.testing.assert_allclose(diag, 1.5 * row_abs + 1.0)


def test_rmat_keeps_its_edges_inside_n_without_loops():
    d, cfg = _data("webgraph-rmat-1m", 9)
    assert d.rows.size == cfg["edges"] == d.nnz
    assert np.unique(d.rows * d.n + d.cols).size == cfg["edges"]
    assert d.rows.max() < d.n and d.cols.max() < d.n
    assert not np.any(d.rows == d.cols)
    # R-MAT is skewed: the largest in-degree far above the mean of 5
    assert np.bincount(d.cols, minlength=d.n).max() > 50


def test_spmv_bytes_by_hand():
    # n=100k, 1,099,990 stored entries, one column: indptr 400,004 bytes,
    # indices and values 8,799,920, x read and y written 800,000
    assert roofline.spmv_bytes(100_000, 1_099_990) == 400_004 + 8_799_920 + 800_000
    # 128 columns: x and y are (n, 128) float32 blocks
    assert roofline.spmv_bytes(100_000, 1_099_990, 128) == (
        400_004 + 8_799_920 + 2 * 4 * 100_000 * 128)
    assert roofline.least_seconds(3.35e12) == pytest.approx(1.0)
    assert roofline.least_seconds(1.0, 67e12) == pytest.approx(1.0)
    assert roofline.share_percent(1.0, 4.0) == 25.0
    assert roofline.share_percent(1.0, 0.0) is None


def _fake_trace():
    """A window of 10 ms holding two requests; kernels of 1 ms and 2 ms in
    the first and one of 3 ms plus a 1 ms copy in the second."""
    ms = 1_000_000
    spans = {WINDOW: [(0, 10 * ms)], REQUEST: [(0, 4 * ms), (5 * ms, 10 * ms)]}
    ops = [DeviceOp(1 * ms, 2 * ms, "k1", True), DeviceOp(2 * ms, 4 * ms, "k2", True),
           DeviceOp(5 * ms, 8 * ms, "k1", True), DeviceOp(8 * ms, 9 * ms, "Memcpy DtoH", False)]
    return Trace(spans, ops, [(4 * ms + 100, 5 * ms - 100, "aten::copy_")])


def test_trace_arithmetic_by_hand():
    tr = _fake_trace()
    assert tr.busy_ns(*tr.window) == 7_000_000
    assert tr.idle_percent() == pytest.approx(30.0)
    assert tr.kernel_ns(tr.spans[REQUEST]) == (6_000_000, 3)
    # request 1: 4 ms less 3 busy; request 2: 5 ms less 4 busy
    assert tr.host_ms_per_request() == pytest.approx(1.0)
    assert dict(tr.top_device_ops()) == pytest.approx({"k1": 0.004, "k2": 0.002,
                                                       "Memcpy DtoH": 0.001})
    gaps = dict(tr.idle_gaps())
    assert gaps["aten::copy_"] == pytest.approx(0.001)
    assert sum(gaps.values()) == pytest.approx(0.003)


def _run(requests, window_s, trace=None, iterations=10):
    cell = harness.load_cell("rsparse-100k.stream")
    reqs = [harness.Request(0.0, 0.0, a, ok, [iterations]) for a, ok in requests]
    data = gen.Data(100_000, None, None, None, 1_099_990, 100_000)
    return harness.Run(cell, data, 9.5, reqs, window_s, trace)


def test_rates_count_every_converged_answer_over_the_whole_window():
    run = _run([(1, 1)] * 999 + [(1, 0)], 2.0)
    assert harness.reader("solutions_per_s")(run) == pytest.approx(999 / 2.0)
    assert harness.reader("ppr_queries_per_s")(run) == pytest.approx(999 / 2.0)
    assert harness.reader("setup_s")(run) == 9.5


def test_solve_roofline_counts_the_products_the_iterations_need():
    tr = _fake_trace()  # 6 ms of kernels in the requests
    run = _run([(1, 1), (1, 1)], 1.0, tr, iterations=10)
    per_solve = 10 * roofline.spmv_bytes(100_000, 999_990) + roofline.spmv_bytes(100_000, 1_099_990)
    want = 100 * 2 * per_solve / 3.35e12 / 6e-3
    assert harness.reader("solve_roofline")(run) == pytest.approx(want)
    assert harness.reader("solve.launches")(run) == 1.5


class _Entry:
    def __init__(self, seconds_each):
        self.seconds_each, self.calls = seconds_each, 0

    def request(self, i):
        import time
        time.sleep(self.seconds_each)
        self.calls += 1
        from bench_port.entries import Outcome
        return Outcome(1, 1, [1], i)


def test_window_lets_the_last_request_finish_and_count():
    entry = _Entry(0.04)
    sample = harness.Reservoir(4, 1)
    requests, window_s = harness._window(entry, 0.1, sample)
    assert len(requests) == entry.calls == 3
    assert window_s >= requests[-1].end - requests[0].start > 0.1
    assert sample.seen == 3 and sorted(sample.items) == [0, 1, 2]


def test_reservoir_is_uniform_and_seeded():
    counts = np.zeros(100)
    for seed in range(400):
        r = harness.Reservoir(10, seed)
        for i in range(100):
            r.offer(i)
        counts[r.items] += 1
    assert counts.sum() == 4000
    assert counts.min() > 15 and counts.max() < 70  # 40 each on average
    a, b = harness.Reservoir(3, 2**33), harness.Reservoir(3, 2**33)
    for i in range(50):
        a.offer(i)
        b.offer(i)
    assert a.items == b.items


def test_spread_is_the_quartile_distance_over_the_median():
    v = [100.0, 101.0, 102.0, 103.0, 104.0, 105.0]
    q1, _, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / statistics.median(v))
    assert stats.trimmed([1.0, 2.0, 3.0, 50.0]) == [1.0, 2.0, 3.0]


@pytest.mark.parametrize("name", CELLS)
def test_result_line_has_the_contract_keys(small_run, name):
    line = small_run(name)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    e2e = {m["name"] for m in BENCH["end_to_end"] if name in m.get("workloads", [name])}
    assert set(line["metrics"]) == e2e
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def test_traced_line_reads_the_spans(small_run):
    line = small_run("webgraph-rmat-1m.ppr", traced=True)
    assert {"ppr.setup_ms", "ppr.loop_ms"} <= set(line["metrics"])
    # no device here: no device metric is read, none is written as 0
    assert "ppr_roofline" not in line["metrics"]
    assert "device_idle.ppr" not in line["metrics"]
    assert line["device"]["window_s"] > 0 and "breakdown" in line


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2
    assert proc.stdout.strip() == ""
    assert "no CUDA card" in proc.stderr


def test_run_names_jax_or_the_jax_package_by_whole_top_level_names():
    from bench_port import run

    assert run.jax_loaded({"numpy": 1, "sublinear_tpu_torch.solvers": 1,
                           "jaxtyping": 1}) == []
    assert run.jax_loaded({"jax.numpy": 1, "sublinear_tpu.ops": 1,
                           "flax": 1}) == ["flax", "jax", "sublinear_tpu"]
