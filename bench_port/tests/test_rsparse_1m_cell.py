"""The million-row headline under Neumann (``rsparse-1m.stream``): found
from its files, correct at its small size with every answer from the
chain path, its per-layer readers (the 100k stream's, and the chain's step
time) by hand on a trace at its size, and nothing to read for the chain's
step time where the port does not count the chain's steps."""
import json
from pathlib import Path

import pytest
from torch.profiler import ProfilerActivity, profile

from bench_port import control, gen, harness, roofline
from bench_port.trace import REQUEST, WINDOW, DeviceOp, Trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "rsparse-1m.stream"
# the 100k stream's readers that list this cell too, the four that read
# as the stream's under names of their own, and the chain's step time
STREAM = ["solve.host_ms", "solve.launches", "solve_roofline",
          "device_idle.solve"]
ALIASES = {f"solve1m.{m}": f"solve.{m}"
           for m in ("self_ms", "loop_host_ms", "copy_ms", "syncs")}
OWN = ["solve1m.chain_step_ms", *ALIASES]
METRICS = STREAM + OWN


@pytest.fixture(autouse=True)
def fresh_counters():
    from sublinear_tpu_torch import tracing

    tracing.reset()
    yield
    tracing.reset()


def test_the_cell_is_found_from_its_files():
    cell = harness.load_cell(CELL)
    assert cell.config["kind"] == "random-sparse" and cell.config["reduced"] == []
    assert cell.config["n"] == 1_000_000 and cell.config["dtype"] == "float32"
    assert cell.traffic == harness.load_cell("rsparse-100k.stream").traffic
    assert cell.traffic["entry"] == "solve" and cell.traffic["method"] == "neumann"
    assert {m["name"] for m in cell.metrics} == {"solutions_per_s", "setup_s",
                                                 *METRICS}
    declared = {m["name"]: m for m in BENCH["per_layer"]}
    for name in OWN:
        assert declared[name]["workloads"] == [CELL]
    for name in STREAM:
        assert declared[name]["workloads"][-1] == CELL
    for name in METRICS:
        assert declared[name]["moves"] == "solutions_per_s"
    for alias, name in ALIASES.items():
        assert declared[alias]["unit"] == declared[name]["unit"]
        assert declared[alias]["layer"] == declared[name]["layer"]


@pytest.mark.parametrize("seed", [3, 2**40 + 9])
def test_sound_runs_are_correct_and_every_answer_is_neumanns(small_run,
                                                             monkeypatch, seed):
    import sublinear_tpu_torch

    seen, original = [], sublinear_tpu_torch.solve

    def solve(*a, **kw):
        r = original(*a, **kw)
        seen.append(r.method)
        return r
    monkeypatch.setattr(sublinear_tpu_torch, "solve", solve)
    line = small_run(CELL, seed=seed)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert seen and set(seen) == {"neumann"}


def test_the_control_in_bfloat16_is_not_correct(small_run):
    line = small_run(CELL, impl=control.control)
    assert line["correct"] is False, line["checks"]
    assert line["checks"]["residual_max"]["value"] > 1e-6


def test_traced_line_reads_the_chains_counters(small_run):
    from sublinear_tpu_torch import SolverOptions, tracing

    line = small_run(CELL, traced=True)
    assert line["correct"] is True, line["checks"]
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert 0 < m["solve1m.copy_ms"] < m["solve.host_ms"]
    assert 0 < m["solve1m.self_ms"] < m["solve.host_ms"]
    assert 0 < m["solve1m.loop_host_ms"] < m["solve.host_ms"]
    # the initial residual with b's norm, one a chunk, two tail norms, x
    assert m["solve1m.syncs"] >= 5
    # no device here: no kernel time, so no step time, share, launches or
    # idle, not 0
    for name in ("solve1m.chain_step_ms", "solve_roofline",
                 "solve.launches", "device_idle.solve"):
        assert name not in m, name
    # the traffic's 3 warm-up requests and the window's 3, each a chain of
    # check_every steps per chunk
    counts = tracing.counters()
    check = SolverOptions().check_every
    assert counts["neumann_chain_calls"] >= 6
    assert counts["neumann_chain_steps"] == check * counts["neumann_chain_calls"]


def _trace(host_ops=()):
    """Two requests, 0-4 ms and 5-10 ms: a 2 ms chain and a 1 ms product in
    the first, a 3 ms chain and a 1 ms copy in the second."""
    ms = 1_000_000
    spans = {WINDOW: [(0, 10 * ms)], REQUEST: [(0, 4 * ms), (5 * ms, 10 * ms)]}
    ops = [DeviceOp(1 * ms, 3 * ms, "neumann_chain_kernel", True),
           DeviceOp(3 * ms, 4 * ms, "csr_spmv_kernel", True),
           DeviceOp(5 * ms, 8 * ms, "neumann_chain_kernel", True),
           DeviceOp(8 * ms, 9 * ms, "Memcpy DtoH", False)]
    host = sorted((int(s * ms), int(e * ms), name) for s, e, name in host_ops)
    return Trace(spans, ops, host)


def _run(trace, iterations=(10, 12)):
    cell = harness.load_cell(CELL)  # trace_warmup 3
    reqs = [harness.Request(0.0, 0.0, 1, 1, [k]) for k in iterations]
    data = gen.Data(1_000_000, None, None, None, 10_999_990, 1_000_000)
    return harness.Run(cell, data, 20.0, reqs, 1.0, trace)


SOLVES = [(0.1, 3.9, "slt.solve"), (0.2, 0.7, "slt.to_device"),
          (3.2, 3.6, "slt.to_host"), (5.1, 9.9, "slt.solve"),
          (5.2, 5.8, "slt.to_device"), (9.0, 9.8, "slt.to_host")]


def test_readers_by_hand():
    from sublinear_tpu_torch import tracing

    run = _run(_trace(SOLVES))
    # (0.5 + 0.4) and (0.6 + 0.8) ms of copies
    assert harness.reader("solve1m.copy_ms")(run) == pytest.approx(1.15)
    # each request span less the busy inside it: 4 - 3, 5 - 4
    assert harness.reader("solve.host_ms")(run) == pytest.approx(1.0)
    # 7 ms busy in the 10 ms window
    assert harness.reader("device_idle.solve")(run) == pytest.approx(30.0)
    # three kernels in the two requests (the copy is no kernel)
    assert harness.reader("solve.launches")(run) == pytest.approx(1.5)
    # 5 ms of chain kernels over 2 requests; 50 steps over 3 warm-up
    # requests and the window's 2: 2.5 ms / 10 steps
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("neumann_chain_calls", 10)
        tracing.count("neumann_chain_steps", 50)
    assert harness.reader("solve1m.chain_step_ms")(run) == pytest.approx(0.25)
    # the four under names of their own read as the stream's
    for alias, name in ALIASES.items():
        assert harness.reader(alias)(run) == harness.reader(name)(run), alias


def test_roofline_bytes_by_hand_at_its_size():
    run = _run(_trace())  # 6 ms of kernels in the requests
    # k products with the off-diagonal part and one with A, each reading
    # indptr (4,000,004 bytes), indices and values (8 per entry) and x, and
    # writing y (8,000,000)
    off = 4_000_004 + 8 * 9_999_990 + 8_000_000
    full = 4_000_004 + 8 * 10_999_990 + 8_000_000
    assert roofline.spmv_bytes(1_000_000, 9_999_990) == off
    want = 100 * ((10 + 12) * off + 2 * full) / 3.35e12 / 6e-3
    assert harness.reader("solve_roofline")(run) == pytest.approx(want)


def test_no_step_time_without_the_chains_counter():
    from sublinear_tpu_torch import tracing

    run = _run(_trace(SOLVES))
    # a port that counts other things but not the chain's steps
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("host_syncs", 30)
    assert harness.reader("solve1m.chain_step_ms")(run) is None
    # the steps counted, but no chain kernel on a device
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("neumann_chain_steps", 50)
    bare = Trace({WINDOW: [(0, 10)], REQUEST: [(0, 4), (5, 10)]}, [], [])
    assert harness.reader("solve1m.chain_step_ms")(_run(bare)) is None
    # and neither port spans nor device work: no step time, share,
    # launches or idle share to read
    for name in ("solve1m.chain_step_ms", "solve_roofline", "solve.launches",
                 "device_idle.solve"):
        assert harness.reader(name)(_run(bare)) is None, name
