"""``batch.pinned_h2d_pct``: 100 staged / all bytes uploaded, from the
port's counters; nothing to read from a port without the staged counter
(the port before it staged uploads) or without ``tracing``."""
import sys

import pytest
from torch.profiler import ProfilerActivity, profile

from bench_port import harness


@pytest.fixture(autouse=True)
def fresh_counters():
    from sublinear_tpu_torch import tracing

    tracing.reset()
    yield
    tracing.reset()


def _count(**counts):
    from sublinear_tpu_torch import tracing

    with profile(activities=[ProfilerActivity.CPU]):
        for name, n in counts.items():
            tracing.count(name, n)


@pytest.mark.parametrize("counts,want", [
    ({}, None),
    ({"h2d_bytes": 4_000}, None),
    ({"h2d_bytes": 0, "pinned_h2d_bytes": 0}, None),
    ({"h2d_bytes": 4_000, "pinned_h2d_bytes": 0}, 0.0),
    ({"h2d_bytes": 4_000, "pinned_h2d_bytes": 3_000}, 75.0),
    ({"h2d_bytes": 4_000, "pinned_h2d_bytes": 4_000,
      "pinned_d2h_bytes": 1_000, "d2h_bytes": 2_000}, 100.0),
])
def test_staged_share(counts, want):
    _count(**counts)
    assert harness.reader("batch.pinned_h2d_pct")(None) == want


def test_a_port_without_tracing(monkeypatch):
    import sublinear_tpu_torch

    _count(h2d_bytes=4_000, pinned_h2d_bytes=4_000)
    monkeypatch.delattr(sublinear_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "sublinear_tpu_torch.tracing", None)
    assert harness.reader("batch.pinned_h2d_pct")(None) is None
