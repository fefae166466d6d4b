#!/usr/bin/env python3
"""The control that each cell's check has to fail: the plain reference put
in the port's place, computed in bfloat16, the precision next below the
port's float32 (the port has no lower path of its own).

    python3 bench_port/control.py --workload <cell> --seeds 1,2,3 --seconds <s>

Runs the cell through the whole harness (data, window, check) once per seed
in one process, with ``impl`` answering every request, and prints each
run's compared numbers; a run must come out ``correct`` false.

The three entries of ``entries.ENTRIES`` have their controls here, whatever
the configuration's kind: the Neumann control sums a fixed 30 terms
(``solve``, ``solve_batch``), the PageRank control takes 100 steps
(``personalized_pagerank``), enough to reach bfloat16's own level, which no
stop rule can pass.  An entry of ``calls/<entry>.py`` brings its own
``control(data, cell, device)`` in that file; without one its cells cannot
be validated, and the control refuses to run.
"""
import argparse
import json
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from bench_port import entries, harness, lookup, reference  # noqa: E402

DTYPE = torch.bfloat16
NEUMANN_TERMS = 30
PAGERANK_STEPS = 100


def _answer(x, iterations):
    return types.SimpleNamespace(solution=x, scores=x, converged=True,
                                 iterations=iterations)


def control(data, cell, device):
    """The reference in bfloat16, as ``harness.run_cell``'s ``impl``."""
    entry = cell.traffic["entry"]
    if entry not in entries.ENTRIES:
        own = getattr(lookup.load(lookup.CALLS_DIR, entry), "control", None)
        if own is None:
            raise SystemExit(
                f"{lookup.CALLS_DIR / entry}.py defines no control(data, "
                f"cell, device): the cell {cell.name} cannot be validated "
                "without one")
        return own(data, cell, device)
    A = reference.Coo.of(data, device, DTYPE)
    if entry == "personalized_pagerank":
        T = reference.Transition.of(A)
        damping = float(cell.config["damping"])

        def answer(_, s):
            x = reference.pagerank(T, s, damping, iterations=PAGERANK_STEPS)
            return _answer(x.double().cpu().numpy(), PAGERANK_STEPS)
        return answer

    def solve(b):
        x = reference.neumann(A, torch.from_numpy(b).to(device, DTYPE),
                              NEUMANN_TERMS)
        return x.double().cpu().numpy()

    if entry == "solve_batch":
        return lambda _, B: [_answer(np.ascontiguousarray(col), NEUMANN_TERMS)
                             for col in solve(np.asarray(B)).T]
    return lambda _, b: _answer(solve(np.asarray(b)), NEUMANN_TERMS)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    passed = 0
    for seed in args.seeds.split(","):
        line = harness.run_cell(cell, int(seed), args.seconds, False,
                                args.device, time.perf_counter(), impl=control)
        print(json.dumps({"workload": args.workload, "seed": int(seed),
                          "correct": line["correct"],
                          "attempted": line["attempted"],
                          "checks": line["checks"]}), flush=True)
        passed += line["correct"]
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
