#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's main path once on the card.

    python3 chip_smoke.py [--trace DIR]

Run from the root of a checkout, on a machine with one CUDA card.  Phases
(each raises on failure, and the script then exits non-zero):

  1. the card: name, and name + power limit as nvidia-smi reports them;
  2. build the CUDA kernels of sublinear_tpu_torch/csrc from source;
  3. at n=100k (random-sparse, density 1e-4, seed 7) hold each kernel to its
     plain PyTorch version on the card: matvec, offdiag_matvec and
     neumann_chain(., 12, with_residual in {False, True, "norm"});
  4. the main path: sublinear_tpu_torch.solve(A, b, method="neumann",
     epsilon=1e-6) at that size, with the kernels' launch counts;
  5. the bench-shaped verified solve neumann_chain(inv_d * b, 12, "norm"),
     timed per solve against the plain version;
  6. the same solve as phase 4 at n=1M (density 1e-5);
  7. the canonical library drive at n=1000 (dense route).

The last two lines are a JSON object with one entry per kernel and the
result {"ok": true, "device": {...}}.  ``--trace DIR`` also profiles one warm
n=100k solve with torch.profiler and writes the trace into DIR.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
N_MAIN, DENSITY_MAIN = 100_000, 1e-4
N_LARGE, DENSITY_LARGE = 1_000_000, 1e-5
SEED = 7
KERNEL_RTOL = 1e-5      # f32 sums taken in another order
SOLVE_RTOL = 1e-5       # host f64 relative residual of a 1e-6 solve
CHAIN_ITERS = 12        # bench.py's verified fixed-iteration solve
CHAIN_RTOL = 1.5e-6     # bench.py's verification margin over EPSILON=1e-6

SOURCES = {
    "csr_spmv": ("sublinear_tpu_torch/csrc/csr_kernels.cu",
                 "sublinear_tpu/ops/xbar.py:348 (_fused_call); "
                 ":247 (_k1_call) + :726 (_k2_call)"),
    "neumann_step": ("sublinear_tpu_torch/csrc/csr_kernels.cu",
                     "sublinear_tpu/ops/xbar.py:490 (_chain_call)"),
}


def phase(name):
    print(f"[chip_smoke] {name}", flush=True)


def rel_err(got, want) -> float:
    """max |got - want| / max |want| (norm-wise, so rows whose sum cancels
    to near zero do not inflate it)."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


def time_ms(torch, fn, reps):
    """Mean ms per call of ``fn`` over ``reps`` warm calls, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_residual(A, x, b) -> float:
    return float(np.linalg.norm(A.csr.matvec(x) - b) / np.linalg.norm(b))


def check_solve(slt, A, b, label):
    r = slt.solve(A, b, method="neumann", epsilon=1e-6)
    rel = host_residual(A, r.solution, b)
    if not (r.converged and np.all(np.isfinite(r.solution))
            and r.solution.shape == b.shape and rel < SOLVE_RTOL):
        raise RuntimeError(f"{label}: converged={r.converged} "
                           f"iterations={r.iterations} host rel residual {rel}")
    return r, rel


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", type=Path, default=None,
                    help="profile one warm n=100k solve into this directory")
    args = ap.parse_args()

    import torch

    phase("1 device")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no card")
    import sublinear_tpu_torch as slt
    from sublinear_tpu_torch.ops import _kernels, csr_spmv as K

    if Path(slt.__file__).resolve().parent.parent != HERE:
        raise RuntimeError(f"sublinear_tpu_torch imported from {slt.__file__},"
                           f" not from this checkout ({HERE})")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {kind}", flush=True)
    print(f"nvidia-smi: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    phase("2 build")
    _, build_s, log = _kernels.build()
    print(f"build seconds: {build_s:.2f}", flush=True)
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    phase(f"3 kernels vs plain at n={N_MAIN}")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    A = slt.generate("random-sparse", N_MAIN, seed=SEED, density=DENSITY_MAIN)
    b = slt.rhs(N_MAIN, seed=SEED)
    if A._op_kind() != "csr":
        raise RuntimeError(f"n={N_MAIN} routes to {A._op_kind()!r}, not 'csr'")
    op = A.op()
    torch.cuda.synchronize()
    print(f"generate+pack seconds: {time.perf_counter() - t0:.2f}  "
          f"nnz={A.nnz} offdiag={op.indices.numel()}", flush=True)
    rng = np.random.default_rng(SEED)
    x = torch.as_tensor(rng.uniform(-1, 1, N_MAIN), dtype=torch.float32,
                        device=dev)
    errs = {"csr_spmv": [], "neumann_step": []}
    for label, diag in (("matvec", op.diag), ("offdiag_matvec", None)):
        got = K.csr_spmv(op, x, diag)
        want = K.csr_spmv_plain(op, x, diag)
        errs["csr_spmv"].append((label, rel_err(got, want),
                                 float((got - want).abs().max())))
    t_start = op.inv_diag * x
    for wr in (False, True, "norm"):
        got = K.neumann_chain(op, t_start, CHAIN_ITERS, wr)
        want = K.neumann_chain_plain(op, t_start, CHAIN_ITERS, wr)
        for i, (g, w) in enumerate(zip(got, want)):
            g, w = g.reshape(-1), w.reshape(-1)
            errs["neumann_step"].append((f"chain[{wr!r}] out{i}",
                                         rel_err(g, w),
                                         float((g - w).abs().max())))
    torch.cuda.synchronize()
    for name, rows in errs.items():
        for label, rel, ab in rows:
            print(f"  {name} {label}: max rel err {rel:.3e} (abs {ab:.3e})",
                  flush=True)
            if not rel <= KERNEL_RTOL:
                raise RuntimeError(f"{name} {label} disagrees with its plain "
                                   f"version: {rel} > {KERNEL_RTOL}")
    ms = {"csr_spmv": time_ms(torch, lambda: K.csr_spmv(op, x, op.diag), 200)}
    plain_ms = {"csr_spmv": time_ms(
        torch, lambda: K.csr_spmv_plain(op, x, op.diag), 200)}

    phase(f"4 main path: solve(method='neumann') at n={N_MAIN}")
    K.LAUNCHES.update(csr_spmv=0, neumann_step=0)
    r, rel = check_solve(slt, A, b, f"n={N_MAIN}")
    launches = dict(K.LAUNCHES)
    if not all(launches.values()):
        raise RuntimeError(f"a kernel of the main path never launched: "
                           f"{launches}")
    print(f"iterations={r.iterations} residual={r.residual:.3e} "
          f"host f64 rel residual={rel:.3e} launches={launches}", flush=True)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    warm = []
    for _ in range(5):
        start.record()
        slt.solve(A, b, method="neumann", epsilon=1e-6)
        end.record()
        end.synchronize()
        warm.append(start.elapsed_time(end))
    print(f"warm solve ms (CUDA events, 5 runs): "
          f"{' '.join(f'{t:.4f}' for t in warm)}", flush=True)
    if args.trace is not None:
        from torch.profiler import ProfilerActivity, profile

        args.trace.mkdir(parents=True, exist_ok=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            slt.solve(A, b, method="neumann", epsilon=1e-6)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t1) * 1e6
        prof.export_chrome_trace(str(args.trace / "solve_n100k.json"))
        from torch.autograd import DeviceType

        by_name = sorted(
            ((getattr(e, "self_device_time_total", 0), e.count, e.key)
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA), reverse=True)
        dev_us = sum(t for t, _, _ in by_name)
        print(f"profile: wall {wall_us:.1f} us, device busy {dev_us:.1f} us, "
              f"idle share {1 - dev_us / wall_us:.4f}", flush=True)
        for t, count, key in by_name[:12]:
            print(f"  {t:10.1f} us  x{count:<4d} {key[:90]}", flush=True)

    phase(f"5 verified {CHAIN_ITERS}-step chain at n={N_MAIN}")
    b_dev = A.pad_vector(b)
    nb = float(np.linalg.norm(b))

    def chain_kernel():
        return K.neumann_chain(op, op.inv_diag * b_dev, CHAIN_ITERS, "norm")

    def chain_plain():
        return K.neumann_chain_plain(op, op.inv_diag * b_dev, CHAIN_ITERS,
                                     "norm")

    for label, fn in (("kernel", chain_kernel), ("plain", chain_plain)):
        res = math.sqrt(float(fn()[2])) / nb
        print(f"  {label}: verified rel residual {res:.3e}", flush=True)
        if not res <= CHAIN_RTOL:
            raise RuntimeError(f"{label} chain residual {res} > {CHAIN_RTOL}")
    # in turns: plain, kernel, kernel, plain
    turns = {"kernel": [], "plain": []}
    for label in ("plain", "kernel", "kernel", "plain"):
        fn = chain_kernel if label == "kernel" else chain_plain
        turns[label].append(time_ms(torch, fn, 100))
    solve_ms = {k: sum(v) / len(v) for k, v in turns.items()}
    print(f"  per verified solve ms: kernel {turns['kernel']} plain "
          f"{turns['plain']}", flush=True)
    ms["neumann_step"] = solve_ms["kernel"] / CHAIN_ITERS
    plain_ms["neumann_step"] = solve_ms["plain"] / CHAIN_ITERS

    phase(f"6 solve(method='neumann') at n={N_LARGE}")
    t0 = time.perf_counter()
    A_big = slt.generate("random-sparse", N_LARGE, seed=SEED,
                         density=DENSITY_LARGE)
    b_big = slt.rhs(N_LARGE, seed=SEED)
    print(f"generate seconds: {time.perf_counter() - t0:.2f} "
          f"nnz={A_big.nnz} kind={A_big._op_kind()}", flush=True)
    if A_big._op_kind() != "csr":
        raise RuntimeError(f"n={N_LARGE} routes to {A_big._op_kind()!r}")
    r_big, rel_big = check_solve(slt, A_big, b_big, f"n={N_LARGE}")
    start.record()
    slt.solve(A_big, b_big, method="neumann", epsilon=1e-6)
    end.record()
    end.synchronize()
    op_big = A_big.op()
    t_big = op_big.inv_diag * A_big.pad_vector(b_big)
    step_ms = time_ms(torch, lambda: K.neumann_chain(
        op_big, t_big, CHAIN_ITERS, "norm"), 20) / CHAIN_ITERS
    print(f"iterations={r_big.iterations} host f64 rel residual="
          f"{rel_big:.3e} warm solve ms {start.elapsed_time(end):.4f} "
          f"neumann_step ms {step_ms:.4f}", flush=True)

    phase("7 canonical drive at n=1000 (dense route)")
    A1 = slt.generate("random-sparse", 1000, seed=7, density=0.001)
    b1 = slt.rhs(1000, seed=7)
    if A1._op_kind() != "dense":
        raise RuntimeError(f"n=1000 routes to {A1._op_kind()!r}")
    r1, rel1 = check_solve(slt, A1, b1, "n=1000")
    print(f"iterations={r1.iterations} host f64 rel residual={rel1:.3e}",
          flush=True)

    kernels = []
    for name in ("csr_spmv", "neumann_step"):
        source, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(ab for _, _, ab in errs[name]),
            "ms": ms[name], "plain_ms": plain_ms[name],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
