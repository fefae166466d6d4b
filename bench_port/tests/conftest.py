"""The benchmark's own CPU checks: ``python -m pytest bench_port/tests -q``
from the root of a checkout.  The port runs on the CPU here, at sizes a test
can hold; the tier-1 suite (``tests/``) does not collect these."""
import sys
import time
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

# small sizes of each configuration: above the port's dense threshold
# (10,240), so the sparse routes run as they do at full size
SMALL = {"rsparse-100k": {"n": 12000, "density": 5e-4},
         "webgraph-rmat-1m": {"n": 4000, "edges": 20000, "scale": 12}}


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    monkeypatch.setenv("SLT_TORCH_DEVICE", "cpu")


@pytest.fixture
def small_run():
    """run(cell name, seed=..., traced=..., impl=...) -> result line of one
    short run of the cell at its small size on the CPU."""
    from bench_port import harness

    def run(name, seed=12345, traced=False, impl=None, seconds=0.3):
        cell = harness.load_cell(name)
        cell.config.update(SMALL[cell.config["name"]])
        cell.traffic["trace_requests"] = 3
        return harness.run_cell(cell, seed, seconds, traced, "cpu",
                                time.perf_counter(), impl=impl)
    return run
