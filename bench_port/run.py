#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card of this machine.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell is an entry of ``workloads`` in
``BENCHMARK.json``; ``--trace 0`` measures its end-to-end metrics, ``--trace
1`` its per-layer metrics from a profiled window.  The last line of standard
output is the result (JSON); the checks against the plain reference are the
last lines of standard error.  Without a CUDA card, or with fewer cards than
the cell asks for, it exits 2 and prints no result: it never falls back to
the CPU.  A process that has loaded JAX or the JAX package by the time
the window has closed exits 1 and prints no result.
"""
import time

T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BUILD = ROOT / "build"
# every compiler cache at a fixed path inside the checkout, so that only a
# cell's first run in a checkout builds anything
CACHES = {"TRITON_CACHE_DIR": BUILD / "triton",
          "TORCH_EXTENSIONS_DIR": BUILD / "torch_extensions",
          "PYTORCH_KERNEL_CACHE_PATH": BUILD / "torch_kernels",
          "CUDA_CACHE_PATH": BUILD / "cuda_cache"}
# top-level module names the port's benchmark never loads
JAX_MODULES = ("jax", "jaxlib", "flax", "sublinear_tpu")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def jax_loaded(modules=None) -> list:
    """The names of ``JAX_MODULES`` among the top-level names of
    ``modules`` (``sys.modules``), compared whole."""
    names = {name.split(".", 1)[0]
             for name in (sys.modules if modules is None else modules)}
    return sorted(names & set(JAX_MODULES))


def main(argv=None) -> int:
    args = parse(argv)
    for var, path in CACHES.items():
        os.environ[var] = str(path)
    sys.path.insert(0, str(ROOT))
    from bench_port import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("bench_port: no CUDA card (torch.cuda.is_available() is False); "
              "the benchmark runs only on the card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"bench_port: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    line = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            "cuda", T0)
    found = jax_loaded()
    if found:
        print(f"bench_port: the run loaded {', '.join(found)}; the port's "
              "benchmark never runs JAX or the JAX package", file=sys.stderr)
        return 1
    print(f"correct {line['correct']}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
