"""``correct`` holds on sound runs and comes out false for the control and
for each fault a cell can have, planted underneath a whole run (the look
for a card skipped, the port on the CPU at a small size)."""
import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_port import control

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SOLVE, BATCH, PPR = "rsparse-100k.stream", "rsparse-100k.batch128", "webgraph-rmat-1m.ppr"


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_sound_runs_are_correct(small_run, name, seed):
    line = small_run(name, seed=seed)
    assert line["correct"] is True, line["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_in_bfloat16_is_not_correct(small_run, name):
    line = small_run(name, impl=control.control)
    assert line["correct"] is False, line["checks"]


def _altered(monkeypatch, name):
    """Every answer's largest entry doubled where the port produces it."""
    if name == PPR:
        # the package's ``pagerank`` function hides the module of that name
        mod = importlib.import_module("sublinear_tpu_torch.graph.pagerank")
        fn = "pagerank_run"
    elif name == BATCH:
        from sublinear_tpu_torch.parallel import sharded as mod
        fn = "_neumann_batch_run"
    else:
        from sublinear_tpu_torch.solvers import neumann as mod
        fn = "_neumann_run"
    original = getattr(mod, fn)

    def altered(*a, **kw):
        x, *rest = original(*a, **kw)
        x = x.clone()
        flat = x.view(-1)
        flat[flat.abs().argmax()] *= 2
        return (x, *rest)
    monkeypatch.setattr(mod, fn, altered)


def _stuck(monkeypatch, name):
    """Every iteration step returns its state unchanged."""
    if name == BATCH:
        from sublinear_tpu_torch.parallel import sharded

        def stuck(op, B, thresholds, max_iters):
            X = op.inv_diag[:, None] * B
            res = torch.linalg.vector_norm(B - op.matmat(X), dim=0)
            return X, max_iters, res.cpu().numpy()
        monkeypatch.setattr(sharded, "_neumann_batch_run", stuck)
        return
    from sublinear_tpu_torch.solvers import base
    original = base.while_iterate
    monkeypatch.setattr(base, "while_iterate",
                        lambda step, *a, **kw: original(lambda s: s, *a, **kw))


def _half_batch(monkeypatch, name):
    """Only the first half of each batch solved; its answers stand in for
    the other half, with their residuals."""
    from sublinear_tpu_torch.parallel import sharded
    original = sharded._neumann_batch_run

    def half(op, B, thresholds, max_iters):
        h = B.shape[1] // 2
        X, k, res = original(op, B[:, :h].contiguous(), thresholds[:h], max_iters)
        return (torch.cat([X, X], dim=1), k, np.concatenate([res, res]))
    monkeypatch.setattr(sharded, "_neumann_batch_run", half)


FAULTS = [(name, _altered) for name in CELLS] + [(name, _stuck) for name in CELLS] + [
    (BATCH, _half_batch)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__.strip('_')}" for n, f in FAULTS])
def test_fault_underneath_is_not_correct(small_run, monkeypatch, name, fault):
    fault(monkeypatch, name)
    line = small_run(name)
    assert line["correct"] is False, line["checks"]
