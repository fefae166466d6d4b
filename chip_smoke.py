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
  7. the canonical library drive at n=1000 (dense route);
  8. the CG kernel against its plain version: cg_chain(., 10) on the SPD
     n=100k matrix (the headline matrix made symmetric: strict upper
     entries mirrored, diagonal 1.5 * |off-diagonal row sum| + 1), all five
     outputs, continuation 5 + 5 = 10, and the time per CG step in turns;
  9. the CG main path: solve(method="cg", epsilon=1e-6) on that matrix, and
     the per-step CG path (check_every=1) beside it;
 10. BiCGSTAB on the (asymmetric) headline matrix, as method="bicgstab" and
     as method="cg", which dispatch routes to BiCGSTAB;
 11. solve(method="cg") on the SPD n=1M matrix (density 1e-5);
 12. CG on the DIA route (the "banded" catalog recipe at n=1M) and on the
     ELL route (random-sparse n=12,000, density 0.03, made symmetric).

The last two lines are a JSON object with one entry per kernel and the
result {"ok": true, "device": {...}}.  ``--trace DIR`` also profiles one warm
n=100k solve each of Neumann, CG and BiCGSTAB with torch.profiler and writes
the traces into DIR.
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
CG_ITERS = 10
CG_RTOL = 1e-4          # f32 CG steps amplify summation-order differences
N_BANDED = 1_000_000
N_ELL, DENSITY_ELL = 12_000, 0.03

SOURCES = {
    "csr_spmv": ("sublinear_tpu_torch/csrc/csr_kernels.cu",
                 "sublinear_tpu/ops/xbar.py:348 (_fused_call); "
                 ":247 (_k1_call) + :726 (_k2_call)"),
    "neumann_step": ("sublinear_tpu_torch/csrc/csr_kernels.cu",
                     "sublinear_tpu/ops/xbar.py:490 (_chain_call)"),
    "cg_step": ("sublinear_tpu_torch/csrc/csr_kernels.cu",
                "sublinear_tpu/ops/xbar.py:619 (_cg_chain_call)"),
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


def check_solve(slt, A, b, label, method="neumann", expect=None, **options):
    r = slt.solve(A, b, method=method, epsilon=1e-6, **options)
    rel = host_residual(A, r.solution, b)
    if not (r.converged and np.all(np.isfinite(r.solution))
            and r.solution.shape == b.shape and rel < SOLVE_RTOL
            and r.method == (expect or method)):
        raise RuntimeError(f"{label}: method={r.method} converged="
                           f"{r.converged} iterations={r.iterations} host rel "
                           f"residual {rel}")
    return r, rel


def symmetric_dd(slt, rows, cols, vals, n):
    """The matrix made symmetric and strictly DD (so SPD): the entries
    (rows < cols) mirrored, diagonal 1.5 * |off-diagonal row sum| + 1 (the
    generator's dominance rule, generate.py:94)."""
    up = rows < cols
    r = np.concatenate([rows[up], cols[up]])
    c = np.concatenate([cols[up], rows[up]])
    v = np.concatenate([vals[up], vals[up]])
    diag = 1.5 * np.bincount(r, weights=np.abs(v), minlength=n) + 1.0
    d = np.arange(n)
    return slt.Matrix.from_coo(np.concatenate([r, d]), np.concatenate([c, d]),
                               np.concatenate([v, diag]), (n, n))


def banded(slt, n, seed=0, band=3):
    """The JAX package's "banded" catalog recipe (generate.py::
    catalog_matrix) from a fixed numpy seed: bands +-1..+-band with U(-1, 1)
    weights, mirrored, diagonal 1.2 * |row sum| + 1."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for off in range(1, band + 1):
        idx = np.arange(n - off)
        w = rng.uniform(-1, 1, size=n - off)
        rows += [idx, idx + off]
        cols += [idx + off, idx]
        vals += [w, w]
    rows, cols, vals = map(np.concatenate, (rows, cols, vals))
    diag = 1.2 * np.bincount(rows, weights=np.abs(vals), minlength=n) + 1.0
    d = np.arange(n)
    return slt.Matrix.from_coo(np.concatenate([rows, d]),
                               np.concatenate([cols, d]),
                               np.concatenate([vals, diag]), (n, n))


def warm_ms(torch, fn, runs):
    """CUDA-event ms of each of ``runs`` calls of ``fn``."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    out = []
    for _ in range(runs):
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def profile_solve(torch, fn, path):
    """One profiled call of ``fn``: wall time, device busy time, idle share
    and the top device kernels by time; the chrome trace goes to ``path``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t1) * 1e6
    prof.export_chrome_trace(str(path))
    by_name = sorted(
        ((getattr(e, "self_device_time_total", 0), e.count, e.key)
         for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA), reverse=True)
    dev_us = sum(t for t, _, _ in by_name)
    print(f"profile {path.name}: wall {wall_us:.1f} us, device busy "
          f"{dev_us:.1f} us, idle share {1 - dev_us / wall_us:.4f}",
          flush=True)
    for t, count, key in by_name[:12]:
        print(f"  {t:10.1f} us  x{count:<4d} {key[:90]}", flush=True)


def reset(K):
    for name in K.LAUNCHES:
        K.LAUNCHES[name] = 0


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
    reset(K)
    r, rel = check_solve(slt, A, b, f"n={N_MAIN}")
    launches = dict(K.LAUNCHES)
    if not (launches["csr_spmv"] and launches["neumann_step"]):
        raise RuntimeError(f"a kernel of the main path never launched: "
                           f"{launches}")
    print(f"iterations={r.iterations} residual={r.residual:.3e} "
          f"host f64 rel residual={rel:.3e} launches={launches}", flush=True)
    warm = warm_ms(torch, lambda: slt.solve(A, b, method="neumann",
                                            epsilon=1e-6), 5)
    print(f"warm solve ms (CUDA events, 5 runs): "
          f"{' '.join(f'{t:.4f}' for t in warm)}", flush=True)
    if args.trace is not None:
        args.trace.mkdir(parents=True, exist_ok=True)
        profile_solve(torch, lambda: slt.solve(A, b, method="neumann",
                                               epsilon=1e-6),
                      args.trace / "solve_n100k.json")

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
    (big_ms,) = warm_ms(torch, lambda: slt.solve(A_big, b_big,
                                                 method="neumann",
                                                 epsilon=1e-6), 1)
    op_big = A_big.op()
    t_big = op_big.inv_diag * A_big.pad_vector(b_big)
    step_ms = time_ms(torch, lambda: K.neumann_chain(
        op_big, t_big, CHAIN_ITERS, "norm"), 20) / CHAIN_ITERS
    print(f"iterations={r_big.iterations} host f64 rel residual="
          f"{rel_big:.3e} warm solve ms {big_ms:.4f} "
          f"neumann_step ms {step_ms:.4f}", flush=True)

    phase("7 canonical drive at n=1000 (dense route)")
    A1 = slt.generate("random-sparse", 1000, seed=7, density=0.001)
    b1 = slt.rhs(1000, seed=7)
    if A1._op_kind() != "dense":
        raise RuntimeError(f"n=1000 routes to {A1._op_kind()!r}")
    r1, rel1 = check_solve(slt, A1, b1, "n=1000")
    print(f"iterations={r1.iterations} host f64 rel residual={rel1:.3e}",
          flush=True)

    phase(f"8 CG kernel vs plain at n={N_MAIN} (SPD)")
    t0 = time.perf_counter()
    S = symmetric_dd(slt, *A.csr.to_coo(), N_MAIN)
    if S._op_kind() != "csr" or not slt.analyze(S).is_symmetric:
        raise RuntimeError(f"SPD n={N_MAIN} routes to {S._op_kind()!r}")
    sop = S.op()
    torch.cuda.synchronize()
    print(f"build+pack seconds: {time.perf_counter() - t0:.2f}  nnz={S.nnz} "
          f"offdiag={sop.indices.numel()}", flush=True)
    b_s = S.pad_vector(b)
    z_s = sop.inv_diag * b_s
    cg0 = (torch.zeros_like(b_s), b_s, z_s, K.dot64(b_s, z_s))
    got = K.cg_chain(sop, *cg0, CG_ITERS)
    want = K.cg_chain_plain(sop, *cg0, CG_ITERS)
    half = K.cg_chain(sop, *cg0, CG_ITERS // 2)
    cont = K.cg_chain(sop, *half[:4], CG_ITERS - CG_ITERS // 2)
    torch.cuda.synchronize()
    errs["cg_step"], cont_errs = [], []
    for rows, pair in ((errs["cg_step"], zip(got, want)),
                       (cont_errs, zip(cont, got))):
        for name, (g, w) in zip(("x", "r", "p", "rz", "res2"), pair):
            g, w = g.reshape(-1), w.reshape(-1)
            rows.append((name, rel_err(g, w),
                         float((g.double() - w.double()).abs().max())))
    for label, rows in (("vs plain", errs["cg_step"]),
                        (f"{CG_ITERS // 2}+{CG_ITERS - CG_ITERS // 2} vs "
                         f"{CG_ITERS}", cont_errs)):
        for name, rel, ab in rows:
            print(f"  cg_step {label} {name}: max rel err {rel:.3e} "
                  f"(abs {ab:.3e})", flush=True)
            if not rel <= CG_RTOL:
                raise RuntimeError(f"cg_step {label} {name}: {rel} > "
                                   f"{CG_RTOL}")
    turns = {"kernel": [], "plain": []}
    for label in ("plain", "kernel", "kernel", "plain"):
        fn = K.cg_chain if label == "kernel" else K.cg_chain_plain
        turns[label].append(time_ms(
            torch, lambda: fn(sop, *cg0, CG_ITERS), 20) / CG_ITERS)
    print(f"  per CG step ms: kernel {turns['kernel']} plain "
          f"{turns['plain']}", flush=True)
    ms["cg_step"] = sum(turns["kernel"]) / 2
    plain_ms["cg_step"] = sum(turns["plain"]) / 2

    phase(f"9 main path: solve(method='cg') at n={N_MAIN} (SPD)")
    reset(K)
    r_cg, rel_cg = check_solve(slt, S, b, f"cg n={N_MAIN}", "cg",
                               "conjugate-gradient")
    launches["cg_step"] = K.LAUNCHES["cg_step"]
    if not (K.LAUNCHES["cg_step"] and K.LAUNCHES["csr_spmv"]):
        raise RuntimeError(f"a kernel of the CG path never launched: "
                           f"{K.LAUNCHES}")
    print(f"iterations={r_cg.iterations} residual={r_cg.residual:.3e} "
          f"host f64 rel residual={rel_cg:.3e} launches={K.LAUNCHES}",
          flush=True)
    warm = warm_ms(torch, lambda: slt.solve(S, b, method="cg",
                                            epsilon=1e-6), 5)
    print(f"warm CG solve ms (CUDA events, 5 runs): "
          f"{' '.join(f'{t:.4f}' for t in warm)}", flush=True)
    r_ps, rel_ps = check_solve(slt, S, b, f"per-step cg n={N_MAIN}", "cg",
                               "conjugate-gradient", check_every=1)
    warm = warm_ms(torch, lambda: slt.solve(S, b, method="cg", epsilon=1e-6,
                                            check_every=1), 3)
    print(f"per-step path (check_every=1): iterations={r_ps.iterations} host "
          f"f64 rel residual={rel_ps:.3e} warm solve ms "
          f"{' '.join(f'{t:.4f}' for t in warm)}", flush=True)
    if args.trace is not None:
        profile_solve(torch, lambda: slt.solve(S, b, method="cg",
                                               epsilon=1e-6),
                      args.trace / "cg_solve_n100k.json")

    phase(f"10 BiCGSTAB at n={N_MAIN} (asymmetric headline matrix)")
    for method in ("bicgstab", "cg"):
        reset(K)
        r_bi, rel_bi = check_solve(slt, A, b, f"{method} n={N_MAIN}", method,
                                   "bicgstab")
        bi_launches = dict(K.LAUNCHES)
        if not bi_launches["csr_spmv"] or bi_launches["cg_step"]:
            raise RuntimeError(f"BiCGSTAB launches {bi_launches}")
        bi_ms = warm_ms(torch, lambda: slt.solve(A, b, method=method,
                                                 epsilon=1e-6), 3)
        print(f"method={method}: ran {r_bi.method}, iterations="
              f"{r_bi.iterations} host f64 rel residual={rel_bi:.3e} "
              f"launches={bi_launches} warm solve ms "
              f"{' '.join(f'{t:.4f}' for t in bi_ms)}", flush=True)
    if args.trace is not None:
        profile_solve(torch, lambda: slt.solve(A, b, method="bicgstab",
                                               epsilon=1e-6),
                      args.trace / "bicgstab_solve_n100k.json")

    phase(f"11 solve(method='cg') at n={N_LARGE} (SPD)")
    t0 = time.perf_counter()
    S_big = symmetric_dd(slt, *A_big.csr.to_coo(), N_LARGE)
    if S_big._op_kind() != "csr":
        raise RuntimeError(f"SPD n={N_LARGE} routes to {S_big._op_kind()!r}")
    print(f"build seconds: {time.perf_counter() - t0:.2f} nnz={S_big.nnz}",
          flush=True)
    reset(K)
    r_cgb, rel_cgb = check_solve(slt, S_big, b_big, f"cg n={N_LARGE}", "cg",
                                 "conjugate-gradient")
    cgb_launches = dict(K.LAUNCHES)
    if not cgb_launches["cg_step"]:
        raise RuntimeError(f"cg_step never launched: {cgb_launches}")
    (cgb_ms,) = warm_ms(torch, lambda: slt.solve(S_big, b_big, method="cg",
                                                 epsilon=1e-6), 1)
    sop_big = S_big.op()
    bb = S_big.pad_vector(b_big)
    zb = sop_big.inv_diag * bb
    cg_big = (torch.zeros_like(bb), bb, zb, K.dot64(bb, zb))
    cg_big_ms = time_ms(torch, lambda: K.cg_chain(
        sop_big, *cg_big, CG_ITERS), 5) / CG_ITERS
    print(f"iterations={r_cgb.iterations} host f64 rel residual={rel_cgb:.3e}"
          f" launches={cgb_launches} warm solve ms {cgb_ms:.4f} cg_step ms "
          f"{cg_big_ms:.4f}", flush=True)
    del S_big, sop_big, cg_big, bb, zb

    phase("12 CG on the DIA and ELL routes")
    t0 = time.perf_counter()
    routes = {"dia": banded(slt, N_BANDED)}
    A_e = slt.generate("random-sparse", N_ELL, seed=SEED, density=DENSITY_ELL)
    routes["ell"] = symmetric_dd(slt, *A_e.csr.to_coo(), N_ELL)
    print(f"build seconds: {time.perf_counter() - t0:.2f}", flush=True)
    for route, M in routes.items():
        if M._op_kind() != route:
            raise RuntimeError(f"{route} matrix routes to {M._op_kind()!r}")
        b_m = slt.rhs(M.shape[0], seed=SEED)
        r_m, rel_m = check_solve(slt, M, b_m, f"{route} cg", "cg",
                                 "conjugate-gradient")
        op_m = M.op()
        if op_m.diag.device.type != "cuda":
            raise RuntimeError(f"{route} operator on {op_m.diag.device}")
        (m_ms,) = warm_ms(torch, lambda: slt.solve(M, b_m, method="cg",
                                                   epsilon=1e-6), 1)
        print(f"{route}: n={M.shape[0]} nnz={M.nnz} {type(op_m).__name__} "
              f"iterations={r_m.iterations} host f64 rel residual="
              f"{rel_m:.3e} warm solve ms {m_ms:.4f}", flush=True)

    kernels = []
    for name in ("csr_spmv", "neumann_step", "cg_step"):
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
