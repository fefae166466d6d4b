"""The benchmark's own CPU checks: ``python -m pytest bench_port/tests -q``
from the root of a checkout.  The port runs on the CPU here, at sizes a test
can hold; the tier-1 suite (``tests/``) does not collect these."""
import sys
import time
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def small(config: dict) -> dict:
    """``config`` at its small size, the configuration's own ``"small"``
    key laid over it.  Each configuration picks its small size above the
    port's dense threshold (10,240) where it has one, so that the sparse
    routes run as they do at full size."""
    return {**config, **config["small"]}


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    monkeypatch.setenv("SLT_TORCH_DEVICE", "cpu")


@pytest.fixture
def small_run():
    """run(cell name, seed=..., traced=..., impl=..., benchmark=...) ->
    result line of one short run of the cell at its small size on the
    CPU; ``benchmark`` is the ``BENCHMARK.json`` that names the cell."""
    from bench_port import harness

    def run(name, seed=12345, traced=False, impl=None, seconds=0.3,
            benchmark=harness.BENCHMARK):
        cell = harness.load_cell(name, benchmark)
        cell.config = small(cell.config)
        cell.traffic["trace_requests"] = 3
        return harness.run_cell(cell, seed, seconds, traced, "cpu",
                                time.perf_counter(), impl=impl)
    return run
