#!/usr/bin/env python3
"""Run one cell several times, each run a fresh process as the benchmark's
checks run it, and record every result.

    python3 bench_port/repeat.py --workload <cell> --seeds 11,12,13 \\
        --seconds <s> --trace <0|1> --out <file.jsonl>

Appends one JSON object per run to ``--out`` (seed, exit code, wall
seconds, the result line, the end of standard error) and prints, per
metric, each run's value, the median and the quartile spread (also
without the run farthest from the median).  The card's
name and power limit (``nvidia-smi``) head the output.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from bench_port.stats import spread, trimmed  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", required=True)
    p.add_argument("--trace", default="0")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    values, worst = {}, 0
    for seed in args.seeds.split(","):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(HERE / "run.py"), "--workload", args.workload,
             "--seed", seed, "--seconds", args.seconds, "--trace", args.trace],
            capture_output=True, text=True, cwd=HERE.parent)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            result = None
        record = {"workload": args.workload, "seed": int(seed),
                  "trace": int(args.trace), "rc": proc.returncode,
                  "wall_s": wall, "card": smi, "result": result,
                  "stderr": proc.stderr[-4000:]}
        with out.open("a") as f:
            f.write(json.dumps(record) + "\n")
        if result is None:
            worst = worst or proc.returncode or 1
            print(f"seed {seed}: rc {proc.returncode}, no result\n"
                  f"{proc.stderr[-3000:]}", flush=True)
            continue
        checks = " ".join(f"{k}={c['value']:.4g}/{c['limit']:.4g}"
                          for k, c in result["checks"].items())
        print(f"seed {seed}: rc {proc.returncode} wall {wall:.1f}s correct "
              f"{result['correct']} attempted {result['attempted']} failed "
              f"{result['failed']} peak {result['device']['memory_peak_bytes']}"
              f" {checks}", flush=True)
        for name, m in result["metrics"].items():
            values.setdefault(name, []).append(m["value"])
    for name, v in values.items():
        line = f"{name}: " + " ".join(f"{x:.6g}" for x in v)
        if len(v) >= 2:
            line += f" | median {statistics.median(v):.6g}"
        if len(v) >= 4:
            line += (f" spread {spread(v):.4f} without the farthest run "
                     f"{spread(trimmed(v)):.4f}")
        print(line, flush=True)
    return worst


if __name__ == "__main__":
    sys.exit(main())
