#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's main path once on the card.

    python3 chip_smoke.py [--trace DIR]

Run from the root of a checkout, on a machine with one CUDA card.  Phases
(each raises on failure, and the script then exits non-zero):

  1. the card: name, and name + power limit as nvidia-smi reports them;
  2. build the CUDA kernels of sublinear_tpu_torch/csrc from source;
  3. at n=100k (random-sparse, density 1e-4, seed 7) hold each kernel to its
     plain PyTorch version on the card: matvec, offdiag_matvec and
     neumann_chain(., 12, with_residual in {False, True, "norm"}); the
     chains' products against csr_spmv bit for bit (the Neumann step's y,
     and the CG step's q against csr_spmv(p, diag)); then csr_spmv's time
     per call against cuSPARSE and its bit identity with a one-column
     csr_spmm on rows of at most SPMV_LONG_ROW entries;
  4. the main path: sublinear_tpu_torch.solve(A, b, method="neumann",
     epsilon=1e-6) at that size, with the kernels' launch and step counts;
  5. the bench-shaped verified solve neumann_chain(inv_d * b, 12, "norm"),
     timed per solve against the plain version, and the products of its
     12th step against csr_spmv bit for bit;
  6. the same solve as phase 4 at n=1M (density 1e-5), the chains'
     products against csr_spmv there, the Neumann step's time beside its
     bound, and phase 3's csr_spmv checks and times at that size;
  7. the canonical library drive at n=1000 (dense route);
  8. the CG kernel against its plain version: cg_chain(., 10) on the SPD
     n=100k matrix (the headline matrix made symmetric: strict upper
     entries mirrored, diagonal 1.5 * |off-diagonal row sum| + 1), all five
     outputs, continuation 5 + 5 = 10, the products against csr_spmv bit
     for bit, and the time per CG step in turns;
  9. the CG main path: solve(method="cg", epsilon=1e-6) on that matrix, and
     the per-step CG path (check_every=1) beside it;
 10. BiCGSTAB on the (asymmetric) headline matrix, as method="bicgstab" and
     as method="cg", which dispatch routes to BiCGSTAB;
 11. solve(method="cg") on the SPD n=1M matrix (density 1e-5), and the CG
     step's time beside its bound;
 12. CG on the DIA route (the "banded" catalog recipe at n=1M) and on the
     ELL route (random-sparse n=12,000, density 0.03, made symmetric);
 13. the default solve(A, b): on the headline matrix with b = e_0 it picks
     forward push ("csr" route, csr_spmv); on the tridiagonal matrix of
     diagonal 2.2 and off-diagonals -1 at n=1M with b = rhs(n, seed=1) it
     picks Chebyshev ("dia" route); and solve(method="chebyshev") on the SPD
     n=100k matrix ("csr" route); with iterations and warm times;
 14. the four dense kernels of ops/dense_fused.py against their plain
     versions, on random-sparse (density 0.01, seed 7) matrices of the dense
     route: dense_neumann_fused at n=768 and n=1536 with B in {1, 4} and a
     warm restart 8 then 8, dense_neumann_fused_bf16x3, dense_jacobi_fused
     and dense_power_fused (on a column-stochastic P^T of a seeded random
     graph with dangling nodes, alpha 0.85) at n=1536, each with iters=8;
     the two Neumann kernels with iters=0 at their path's n, and
     dense_neumann_fused on the same recipe's matrix at n=3000 stored
     dense (36 MB of A, more than the card's shared memory: rows read from
     global memory inside the persistent kernel) with B in {1, 4}; and the
     time per call of each at B=1 in turns;
 15. the dense fused path: solve_neumann_fused at n=768, epsilon 1e-6
     ("neumann-fused-highest"), at n=1536, epsilon 1e-3
     ("neumann-fused-bf16x3"), and at n=1536, epsilon 1e-6 (the fallback to
     "neumann"), with launch counts and warm solve times;
 16. the SpMM kernel against its plain version at n=100k: csr_spmm as
     CsrOperator.matmat runs it (f32, split diagonal) for B in {8, 128},
     with cuSPARSE's time and the bit identity of single columns (across the
     column slabs) with the product of that column alone, and onehot_spmm on
     build_tiles of the same matrix at B=128 with precise in {True, False},
     each timed in turns with the plain version;
 17. the batch path: parallel.sharded.solve_batch at n=100k with 128 RHS
     (numpy default_rng(0) standard normal, as bench.py's batch row) and
     epsilon 1e-6, method="neumann" on the headline matrix and
     method="auto" (CG) on its SPD form, with launch counts, each column's
     host f64 residual and warm times per batch and per RHS;
 18. the small-batch path: solve_batch with 20 RHS at n=100k, which runs
     serialized Neumann chain solves (neumann_step, no csr_spmm);
 19. the figures of csr_spmv (phases 3 and 6) and csr_spmm (phase 16, f32)
     with their device times, the device times of the two chain kernels at
     n=100k (neumann_step per step of phase 5's chain, cg_step per step of
     phase 8's), and the device time and device launches per call of the
     four dense kernels at their timed shapes (raising unless each Neumann
     call is one launch).  They come last because a torch.profiler window
     slows the host-bound solves that follow it in the same process
     (BiCGSTAB, CG on the ELL route).

Beside each kernel's time the script computes its bound (the least time the
card could take: the bytes the function must move at 3.35 TB/s, or its
operations at the card's peak for their type, whichever is larger) and, for
csr_spmv and csr_spmm, times one PyTorch call that computes the same
function (a CUDA torch.sparse_csr_tensor of A times x, or times X with
torch.sparse.mm) as a yardstick the port never calls.  The figures of those
two kernels: the time per back-to-back call (CUDA events, host work
included), the device time alone (torch.profiler over a window of
back-to-back calls, phase 19), both also for the yardstick, the bound and
its share,
the bytes per second achieved (the bound's bytes over the device time) and
the L2 traffic of the gathers, computed from the shapes (a 32-byte sector
per gathered x element for csr_spmv, 4 * B bytes per entry for csr_spmm).
The last two lines are a JSON object with one entry per kernel and the
result {"ok": true, "device": {...}}.  ``--trace DIR`` also profiles one
warm n=100k solve each of Neumann, CG and BiCGSTAB, one warm n=768 fused
solve and one warm 128-RHS Neumann batch, with torch.profiler and writes
the traces into DIR.
"""
from __future__ import annotations

import argparse
import dataclasses
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
DENSE_SIZES, DENSITY_DENSE = (768, 1536), 0.01
DENSE_ITERS = 8         # solve_neumann_fused's block
N_DENSE_GLOBAL = 3000   # A larger than the card's shared memory
X3_RTOL = 1e-4          # bf16x3: the bf16 split of t may round the other way
N_RHS = 128             # bench.py's batch row (bench_batch_point)
N_RHS_CHAIN = 20        # solve_batch's serialized-chain path (<= 32 RHS)
SPMM_WIDTHS = (8, 128)
DEVICE_REPS = 50        # back-to-back calls in a profiled window
SECTOR_BYTES = 32       # what L2 moves for one gathered 4-byte x element
# f32 operations per stored entry and column of each csr_spmm product
SPMM_OPS = {"f32": 2, "split": 9, "bf16": 2}
# the card's published peaks (H100 SXM data sheet, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}

SOURCES = {
    "csr_spmv": ("sublinear_tpu_torch/csrc/csr_kernels.cu",
                 "sublinear_tpu/ops/xbar.py:348 (_fused_call); "
                 ":247 (_k1_call) + :726 (_k2_call)"),
    "neumann_step": ("sublinear_tpu_torch/csrc/csr_kernels.cu",
                     "sublinear_tpu/ops/xbar.py:490 (_chain_call)"),
    "cg_step": ("sublinear_tpu_torch/csrc/csr_kernels.cu",
                "sublinear_tpu/ops/xbar.py:619 (_cg_chain_call)"),
    "dense_neumann_fused": (
        "sublinear_tpu_torch/csrc/dense_kernels.cu",
        "sublinear_tpu/ops/pallas_kernels.py:57 (dense_neumann_fused)"),
    "dense_neumann_fused_bf16x3": (
        "sublinear_tpu_torch/csrc/dense_kernels.cu",
        "sublinear_tpu/ops/pallas_kernels.py:177 "
        "(dense_neumann_fused_bf16x3)"),
    "dense_jacobi_fused": (
        "sublinear_tpu_torch/csrc/dense_kernels.cu",
        "sublinear_tpu/ops/pallas_kernels.py:96 (dense_jacobi_fused)"),
    "dense_power_fused": (
        "sublinear_tpu_torch/csrc/dense_kernels.cu",
        "sublinear_tpu/ops/pallas_kernels.py:124 (dense_power_fused)"),
    "csr_spmm": ("sublinear_tpu_torch/csrc/spmm_kernels.cu",
                 "sublinear_tpu/ops/pallas_spmv.py:180 (onehot_spmm)"),
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


def bound(nbytes, flops, kind="f32"):
    """(ms, "bytes" or "operations"): the larger of the bytes over the HBM
    rate and the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dense_bound(name, n, B, iters):
    """Bound of one call of a dense kernel at (n, B, iters): A (or its two
    bf16 halves, or P^T) read once, the (n, 1) and (n, B) inputs read once,
    x written once; 2 n^2 B flops per product plus the epilogue's."""
    if name == "dense_neumann_fused":
        return bound(4 * n * n + 8 * n + 12 * n * B,
                     (2 * n * n * B + 4 * n * B) * (iters + 1))
    if name == "dense_neumann_fused_bf16x3":
        # three bf16 x bf16 products, exact in f32: the bf16 peak
        return bound(4 * n * n + 8 * n + 12 * n * B,
                     3 * 2 * n * n * B * (iters + 1), "bf16")
    if name == "dense_jacobi_fused":
        return bound(4 * n * n + 8 * n + 12 * n * B,
                     (2 * n * n * B + 5 * n * B) * iters)
    return bound(4 * n * n + 12 * n * B, (2 * n * n * B + 7 * n * B) * iters)


def chain_bounds(op):
    """{kernel: (ms, by)}: the bound of one Neumann step (indptr, the
    off-diagonal CSR, t_in, inv_d and acc read; t_out and acc written) and
    of one CG step (indptr, the CSR, diag, inv_d, x, r and p read; x, r, p
    written) on ``op``."""
    n, nnz = op.n_pad, op.indices.numel()
    return {"neumann_step": bound(4 * (n + 1) + 8 * nnz + 20 * n,
                                  2 * nnz + 3 * n),
            "cg_step": bound(4 * (n + 1) + 8 * nnz + 32 * n,
                             2 * nnz + 13 * n)}


def check_chain_products(torch, K, op, x, label, iters=1):
    """Raise unless both chains' products of step ``iters`` equal csr_spmv's
    bit for bit: the Neumann step's y (-res of a chain with_residual=True)
    and last term against csr_spmv of the term before, the CG step's q
    (``q_out``) against csr_spmv(p, diag) of the direction before."""
    t_prev = x if iters == 1 else K.neumann_chain(op, x, iters - 1)[1]
    _, last, res = K.neumann_chain(op, x, iters, True)
    y = K.csr_spmv(op, t_prev)
    z = op.inv_diag * x
    state = (torch.zeros_like(x), x, z, K.dot64(x, z))
    p_prev = z if iters == 1 else K.cg_chain(op, *state, iters - 1)[2]
    q = torch.empty_like(x)
    K.cg_chain(op, *state, iters, q_out=q)
    if not (torch.equal(-res, y) and torch.equal(last, -(op.inv_diag * y))):
        raise RuntimeError(f"neumann_chain's step {iters} product differs "
                           f"from csr_spmv at {label}")
    if not torch.equal(q, K.csr_spmv(op, p_prev, op.diag)):
        raise RuntimeError(f"cg_chain's step {iters} product differs from "
                           f"csr_spmv(p, diag) at {label}")
    print(f"  step {iters} products at {label}: neumann_step y == csr_spmv("
          f"t), cg_step q == csr_spmv(p, diag), bit for bit", flush=True)


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


def tridiagonal(slt, n, diag=2.2):
    """The symmetric tridiagonal matrix of diagonal ``diag`` and
    off-diagonals -1: weakly dominant, so the default solve() picks
    Chebyshev."""
    i = np.arange(n)
    return slt.Matrix.from_coo(
        np.r_[i, i[:-1], i[1:]], np.r_[i, i[1:], i[:-1]],
        np.r_[np.full(n, diag), -np.ones(n - 1), -np.ones(n - 1)], (n, n))


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


def sparse_csr(torch, A, dev):
    """The full A (the diagonal included) as a CUDA torch.sparse_csr_tensor,
    for the cuSPARSE yardsticks the port never calls."""
    csr = A.csr
    return torch.sparse_csr_tensor(
        torch.as_tensor(csr.indptr.astype(np.int32)),
        torch.as_tensor(csr.indices.astype(np.int32)),
        torch.as_tensor(csr.data.astype(np.float32)), size=csr.shape,
        device=dev)


def device_profile(torch, fn, reps=DEVICE_REPS, kernel=None):
    """(mean device ms per call, device launches per call) of ``fn``: the
    own time of every kernel and copy on the card under torch.profiler
    (only those whose name holds ``kernel``, or one of a tuple of names, if
    given), over ``reps`` back-to-back warm calls; the ms are None when the
    profiler saw no such device time.  The profiler now and then loses
    records of a window, so each kernel's time is its mean over the
    launches it recorded, times its launches per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = (kernel,) if isinstance(kernel, str) else kernel
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us, launches = 0.0, 0
    for e in prof.key_averages():
        if not (e.device_type == DeviceType.CUDA and e.count
                and (names is None or any(k in e.key for k in names))):
            continue
        per_call = max(1, round(e.count / reps))
        total_us += getattr(e, "self_device_time_total", 0) / e.count * per_call
        launches += per_call
    return (total_us / 1e3 if total_us > 0 else None), launches


def device_ms(torch, fn, reps=DEVICE_REPS, kernel=None):
    """Mean device ms per call of ``fn`` (``device_profile``'s first)."""
    return device_profile(torch, fn, reps, kernel)[0]


def fmt_ms(v) -> str:
    return "not measured" if v is None else f"{v:.5f}"


@dataclasses.dataclass
class Figures:
    """One sparse product at one shape: its kernel and cuSPARSE calls, their
    ms per call, the bytes it must move, its bound (ms, by) and the L2
    traffic of its gathers."""
    label: str
    kern: object
    lib: object
    k_ms: float
    lib_ms: float
    nbytes: int
    bound: tuple
    l2_bytes: int

    def report(self, torch):
        """Print the figures with both device times; returns the kernel's
        device ms."""
        k_dev, lib_dev = device_ms(torch, self.kern), device_ms(torch,
                                                                 self.lib)
        t = k_dev if k_dev is not None else self.k_ms
        b_ms, b_by = self.bound
        print(f"  {self.label}: per call {self.k_ms:.5f} ms, device "
              f"{fmt_ms(k_dev)} ms; cuSPARSE per call {self.lib_ms:.5f} ms, "
              f"device {fmt_ms(lib_dev)} ms; bound {b_ms:.5f} ms ({b_by}), "
              f"{b_ms / t:.3f} of it; {self.nbytes / t / 1e6:.1f} GB/s of "
              f"{self.nbytes / 1e6:.2f} MB; L2 gather traffic "
              f"{self.l2_bytes / 1e6:.1f} MB", flush=True)
        return k_dev


def spmv_figures(torch, K, A, op, x, label, reps):
    """csr_spmv at one size against cuSPARSE (torch.mv of a CUDA
    torch.sparse_csr_tensor of the full A, a yardstick the port never
    calls), after raising unless the yardstick agrees with the kernel and,
    on rows of at most SPMV_LONG_ROW entries, csr_spmv equals a one-column
    csr_spmm bit for bit.  Returns the ``Figures`` phase 19 prints."""
    n, nnz = op.n_pad, op.indices.numel()
    S = sparse_csr(torch, A, x.device)
    kern, lib = lambda: K.csr_spmv(op, x, op.diag), lambda: torch.mv(S, x)
    err = rel_err(lib(), kern())
    if not err <= KERNEL_RTOL:
        raise RuntimeError(f"sparse_csr product disagrees with csr_spmv at "
                           f"{label}: {err}")
    short = torch.diff(op.indptr) <= K.SPMV_LONG_ROW
    for diag in (op.diag, None):
        y = K.csr_spmv(op, x, diag)
        Y = K.csr_spmm(op, x[:, None].contiguous(), diag)
        if not torch.equal(y[short], Y[short, 0]):
            raise RuntimeError(f"csr_spmv differs from csr_spmm(x[:, None])"
                               f" on short rows at {label}")
    print(f"  csr_spmv == csr_spmm(x[:, None])[:, 0] bit for bit on "
          f"{int(short.sum())} of {n} rows (the rows of at most "
          f"{K.SPMV_LONG_ROW} entries); {op.row_blocks.numel() - 1} row "
          f"blocks; cuSPARSE max rel diff {err:.3e}", flush=True)
    k_ms, lib_ms = time_ms(torch, kern, reps), time_ms(torch, lib, reps)
    print(f"  csr_spmv at {label} ms per call: kernel {k_ms:.5f}, cuSPARSE "
          f"{lib_ms:.5f}", flush=True)
    # indptr, off-diagonal indices and values, x, diag and y once each
    nbytes = 4 * (n + 1) + 8 * nnz + 12 * n
    return Figures(f"csr_spmv at {label}", kern, lib, k_ms, lib_ms, nbytes,
                   bound(nbytes, 2 * nnz + 2 * n), SECTOR_BYTES * nnz)


def host_residuals(A, X, B):
    """Each column's host f64 relative residual ||A x_j - b_j|| / ||b_j||."""
    csr = A.csr
    rows = csr.row_of_entry()
    return np.array([
        np.linalg.norm(np.bincount(rows, weights=csr.data * X[csr.indices, j],
                                   minlength=A.shape[0]) - B[:, j])
        / np.linalg.norm(B[:, j]) for j in range(B.shape[1])])


def host_steps_ms(torch, Bm, dev):
    """Wall ms of the host-side steps of one solve_batch call around its
    batch loop: the column norms, B's f64->f32 conversion and upload, and
    X's download and f32->f64 conversion (X taken the size of B)."""
    from sublinear_tpu_torch.config import to_device

    out, t0 = {}, time.perf_counter()
    np.linalg.norm(Bm, axis=0)
    t1 = time.perf_counter()
    B_dev = to_device(Bm, torch.float32, dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    X = B_dev.cpu()
    t3 = time.perf_counter()
    X.numpy().astype(np.float64)
    t4 = time.perf_counter()
    for name, a, b in (("norms", t0, t1), ("to f32 + upload", t1, t2),
                       ("download", t2, t3), ("to f64", t3, t4)):
        out[name] = round((b - a) * 1e3, 3)
    return out


def in_turns(torch, kern, plain, reps):
    """Mean CUDA-event ms per call of kern and of plain, timed in turns
    (plain, kernel, kernel, plain), and the four readings."""
    turns = {"kernel": [], "plain": []}
    for label in ("plain", "kernel", "kernel", "plain"):
        turns[label].append(time_ms(
            torch, kern if label == "kernel" else plain, reps))
    return (sum(turns["kernel"]) / 2, sum(turns["plain"]) / 2, turns)


def reset(*modules):
    """Set every launch (and step) count of ``modules`` to 0."""
    for mod in modules:
        for counts in (mod.LAUNCHES, getattr(mod, "STEPS", {})):
            for name in counts:
                counts[name] = 0


def dense_dd(torch, slt, n, dev):
    """(A, diag, inv_diag) of the generator's seeded DD matrix
    (random-sparse, density DENSITY_DENSE, seed SEED) stored dense, as f32
    tensors; the columns (n, 1)."""
    a = torch.as_tensor(slt.generate("random-sparse", n, seed=SEED,
                                     density=DENSITY_DENSE).to_dense(),
                        dtype=torch.float32, device=dev)
    d = torch.diagonal(a).clone()[:, None]
    return a, d, 1.0 / d


def stochastic(torch, n, B, dev, seed=SEED):
    """(P^T, v, dangling) of a seeded random graph (out-degree about 15)
    with every eighth node dangling; P^T is column-stochastic, v positive
    with columns summing to 1."""
    rng = np.random.default_rng(seed)
    adj = (rng.random((n, n)) < 15.0 / n).astype(np.float64)
    np.fill_diagonal(adj, 0.0)
    adj[::8] = 0.0
    deg = adj.sum(axis=1)
    pt = (adj / np.where(deg > 0, deg, 1.0)[:, None]).T
    v = rng.random((n, B)) + 0.5
    v /= v.sum(axis=0)
    dang = np.repeat((deg == 0).astype(np.float64)[:, None], B, 1)
    return tuple(torch.as_tensor(np.ascontiguousarray(m), dtype=torch.float32,
                                 device=dev) for m in (pt, v, dang))


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
    from sublinear_tpu_torch.ops import dense_fused as DF
    from sublinear_tpu_torch.solvers.fused import solve_neumann_fused

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
    check_chain_products(torch, K, op, x, f"n={N_MAIN}")
    # the figures phase 19 prints, by kernel, the first of each on the path
    late = {"csr_spmv": [spmv_figures(torch, K, A, op, x, f"n={N_MAIN}",
                                      200)]}
    main_fig = late["csr_spmv"][0]
    ms = {"csr_spmv": main_fig.k_ms}
    library_ms = {"csr_spmv": main_fig.lib_ms}
    bounds = {"csr_spmv": main_fig.bound}
    plain_ms = {"csr_spmv": time_ms(
        torch, lambda: K.csr_spmv_plain(op, x, op.diag), 200)}
    nnz_off = op.indices.numel()
    # one step: the matrix, t_in, inv_d and acc read, t_out and acc written
    bounds["neumann_step"] = chain_bounds(op)["neumann_step"]

    phase(f"4 main path: solve(method='neumann') at n={N_MAIN}")
    reset(K)
    r, rel = check_solve(slt, A, b, f"n={N_MAIN}")
    launches = dict(K.LAUNCHES)
    if not (launches["csr_spmv"] and launches["neumann_step"]):
        raise RuntimeError(f"a kernel of the main path never launched: "
                           f"{launches}")
    print(f"iterations={r.iterations} residual={r.residual:.3e} "
          f"host f64 rel residual={rel:.3e} launches={launches} steps="
          f"{K.STEPS}", flush=True)
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
    check_chain_products(torch, K, op, op.inv_diag * b_dev, f"n={N_MAIN}",
                         CHAIN_ITERS)
    k_ms, p_ms, turns = in_turns(torch, chain_kernel, chain_plain, 100)
    print(f"  per verified solve ms: kernel {turns['kernel']} plain "
          f"{turns['plain']}", flush=True)
    ms["neumann_step"] = k_ms / CHAIN_ITERS
    plain_ms["neumann_step"] = p_ms / CHAIN_ITERS

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
    check_chain_products(torch, K, op_big, t_big, f"n={N_LARGE}")
    step_ms = time_ms(torch, lambda: K.neumann_chain(
        op_big, t_big, CHAIN_ITERS, "norm"), 20) / CHAIN_ITERS
    big_bound = chain_bounds(op_big)["neumann_step"]
    print(f"iterations={r_big.iterations} host f64 rel residual="
          f"{rel_big:.3e} warm solve ms {big_ms:.4f} neumann_step ms per "
          f"step {step_ms:.5f}, bound {big_bound[0]:.5f} ms ({big_bound[1]})"
          f", {big_bound[0] / step_ms:.3f} of it", flush=True)
    late["csr_spmv"].append(spmv_figures(torch, K, A_big, op_big,
                                         t_big.clone(), f"n={N_LARGE}", 50))

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
    check_chain_products(torch, K, sop, b_s, f"n={N_MAIN} SPD")
    k_ms, p_ms, turns = in_turns(
        torch, lambda: K.cg_chain(sop, *cg0, CG_ITERS),
        lambda: K.cg_chain_plain(sop, *cg0, CG_ITERS), 20)
    print(f"  per CG chain of {CG_ITERS} steps ms: kernel {turns['kernel']} "
          f"plain {turns['plain']}", flush=True)
    ms["cg_step"], plain_ms["cg_step"] = k_ms / CG_ITERS, p_ms / CG_ITERS
    bounds["cg_step"] = chain_bounds(sop)["cg_step"]

    phase(f"9 main path: solve(method='cg') at n={N_MAIN} (SPD)")
    reset(K)
    r_cg, rel_cg = check_solve(slt, S, b, f"cg n={N_MAIN}", "cg",
                               "conjugate-gradient")
    launches["cg_step"] = K.LAUNCHES["cg_step"]
    if not (K.LAUNCHES["cg_step"] and K.LAUNCHES["csr_spmv"]):
        raise RuntimeError(f"a kernel of the CG path never launched: "
                           f"{K.LAUNCHES}")
    print(f"iterations={r_cg.iterations} residual={r_cg.residual:.3e} "
          f"host f64 rel residual={rel_cg:.3e} launches={K.LAUNCHES} steps="
          f"{K.STEPS}", flush=True)
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
    big_bound = chain_bounds(sop_big)["cg_step"]
    print(f"iterations={r_cgb.iterations} host f64 rel residual={rel_cgb:.3e}"
          f" launches={cgb_launches} steps={K.STEPS} warm solve ms "
          f"{cgb_ms:.4f} cg_step ms per step {cg_big_ms:.5f}, bound "
          f"{big_bound[0]:.5f} ms ({big_bound[1]}), "
          f"{big_bound[0] / cg_big_ms:.3f} of it", flush=True)
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

    phase("13 the default solve(): forward push and Chebyshev")
    e0 = np.zeros(N_MAIN)
    e0[0] = 1.0
    T = tridiagonal(slt, N_LARGE)
    b_t = slt.rhs(N_LARGE, seed=1)
    for label, M, rhs_m, method, expect, route in (
            (f"default solve, headline n={N_MAIN}, b = e_0", A, e0, None,
             "forward-push", "csr"),
            (f"method='chebyshev', SPD n={N_MAIN}", S, b, "chebyshev",
             "chebyshev", "csr"),
            (f"default solve, tridiagonal n={N_LARGE}", T, b_t, None,
             "chebyshev", "dia")):
        if M._op_kind() != route:
            raise RuntimeError(f"{label} routes to {M._op_kind()!r}")
        reset(K)
        r_m = slt.solve(M, rhs_m, method=method)
        counts = dict(K.LAUNCHES)
        rel_m = host_residual(M, r_m.solution, rhs_m)
        # the default solve may polish a stalled push with a Krylov method
        method_ok = r_m.method == expect or (
            method is None and r_m.method.startswith(f"adaptive({expect}->"))
        launched_ok = (counts["csr_spmv"] > 0 if route == "csr"
                       else not any(counts.values()))
        if not (r_m.converged and np.all(np.isfinite(r_m.solution))
                and r_m.solution.shape == rhs_m.shape and rel_m < SOLVE_RTOL
                and method_ok and launched_ok):
            raise RuntimeError(f"{label}: method={r_m.method} converged="
                               f"{r_m.converged} iterations={r_m.iterations}"
                               f" host rel residual {rel_m} launches "
                               f"{counts}")
        warm = warm_ms(torch, lambda: slt.solve(M, rhs_m, method=method), 3)
        print(f"{label}: ran {r_m.method}, iterations={r_m.iterations} "
              f"residual={r_m.residual:.3e} host f64 rel residual="
              f"{rel_m:.3e} launches={counts} warm solve ms "
              f"{' '.join(f'{t:.4f}' for t in warm)}", flush=True)
    del T, b_t

    phase(f"14 dense kernels vs plain at n={DENSE_SIZES}, "
          f"iters={DENSE_ITERS}")
    dense = {}
    for n in DENSE_SIZES:
        dense[n] = slt.generate("random-sparse", n, seed=SEED,
                                density=DENSITY_DENSE)
        if dense[n]._op_kind() != "dense":
            raise RuntimeError(f"n={n} routes to {dense[n]._op_kind()!r}, "
                               "not 'dense'")
    rng = np.random.default_rng(SEED)
    dense_ops = {n: dense_dd(torch, slt, n, dev)
                 for n in DENSE_SIZES + (N_DENSE_GLOBAL,)}

    def dense_case(name, n, B, iters=DENSE_ITERS):
        """(kernel call, plain call) of one dense kernel at (n, B)."""
        if name == "dense_power_fused":
            pt, v, dang = stochastic(torch, n, B, dev)
            return (lambda: DF.dense_power_fused(pt, v, dang, 0.85, iters),
                    lambda: DF.dense_power_fused_plain(pt, v, dang, 0.85,
                                                       iters))
        a_d, d, dinv = dense_ops[n]
        b_d, x_d = (torch.as_tensor(s * rng.standard_normal((n, B)),
                                    dtype=torch.float32, device=dev)
                    for s in (1.0, 0.1))
        if name == "dense_neumann_fused_bf16x3":
            ah, al = DF.split_bf16(a_d)
            return (lambda: DF.dense_neumann_fused_bf16x3(
                        ah, al, d, dinv, b_d, x_d, iters),
                    lambda: DF.dense_neumann_fused_bf16x3_plain(
                        ah, al, d, dinv, b_d, x_d, iters))
        fn, plain = getattr(DF, name), getattr(DF, name + "_plain")
        return (lambda: fn(a_d, d, dinv, b_d, x_d, iters),
                lambda: plain(a_d, d, dinv, b_d, x_d, iters))

    # the shape each kernel's time is reported at: the fused path's for
    # the two Neumann variants, the widest for the two no path runs
    timed = {"dense_neumann_fused": (768, 1),
             "dense_neumann_fused_bf16x3": (1536, 1),
             "dense_jacobi_fused": (1536, 1), "dense_power_fused": (1536, 1)}
    cases = [("dense_neumann_fused", n, B, DENSE_ITERS)
             for n in DENSE_SIZES + (N_DENSE_GLOBAL,) for B in (1, 4)]
    cases += [(name, 1536, B, DENSE_ITERS)
              for name in ("dense_neumann_fused_bf16x3", "dense_jacobi_fused",
                           "dense_power_fused") for B in (1, 4)]
    # iters=0: x0 + D^-1 (b - A x0), no grid barrier
    cases += [(name, n, 1, 0) for name, (n, _) in timed.items()
              if name.startswith("dense_neumann")]
    dense_fns = {}  # the calls phase 19 profiles, at the timed shapes
    for name, n, B, iters in cases:
        kern, plain = dense_case(name, n, B, iters)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        rel = rel_err(got, want)
        label = f"n={n} B={B} iters={iters}"
        errs.setdefault(name, []).append(
            (label, rel, float((got - want).abs().max())))
        limit = X3_RTOL if name.endswith("bf16x3") else KERNEL_RTOL
        print(f"  {name} {label}: max rel err {rel:.3e}", flush=True)
        if not rel <= limit:
            raise RuntimeError(f"{name} {label} disagrees with its plain "
                               f"version: {rel} > {limit}")
        if B != 1 or iters != DENSE_ITERS:
            continue
        k_ms, p_ms, turns = in_turns(torch, kern, plain, 50)
        b_ms, b_by = dense_bound(name, n, B, DENSE_ITERS)
        print(f"  {name} n={n} B=1 ms per call: kernel {turns['kernel']} "
              f"plain {turns['plain']}; bound {b_ms:.5f} ms ({b_by}), "
              f"{b_ms / k_ms:.3f} of it", flush=True)
        if (n, B) == timed[name]:
            ms[name], plain_ms[name] = k_ms, p_ms
            bounds[name] = (b_ms, b_by)
            dense_fns[name] = kern
    for n in DENSE_SIZES:  # warm restart: 8 then 8 against plain 8 then 8
        dop = dense[n].op()
        d, dinv = dop.diag[:, None], dop.inv_diag[:, None]
        b_d = dense[n].pad_vector(slt.rhs(n, seed=SEED))[:, None]
        x0_d = torch.zeros_like(b_d)
        got = DF.dense_neumann_fused(dop.data, d, dinv, b_d,
                                     DF.dense_neumann_fused(
                                         dop.data, d, dinv, b_d, x0_d, 8), 8)
        want = DF.dense_neumann_fused_plain(
            dop.data, d, dinv, b_d,
            DF.dense_neumann_fused_plain(dop.data, d, dinv, b_d, x0_d, 8), 8)
        rel = rel_err(got, want)
        errs["dense_neumann_fused"].append(
            (f"n={n} 8+8", rel, float((got - want).abs().max())))
        print(f"  dense_neumann_fused n={n} warm restart 8+8: max rel err "
              f"{rel:.3e}", flush=True)
        if not rel <= KERNEL_RTOL:
            raise RuntimeError(f"warm restart at n={n}: {rel} > "
                               f"{KERNEL_RTOL}")

    phase("15 the dense fused path: solve_neumann_fused")
    for n, eps, expect, key in (
            (768, 1e-6, "neumann-fused-highest", "dense_neumann_fused"),
            (1536, 1e-3, "neumann-fused-bf16x3",
             "dense_neumann_fused_bf16x3"),
            (1536, 1e-6, "neumann", None)):
        M, b_m = dense[n], slt.rhs(n, seed=SEED)
        opts = slt.SolverOptions(epsilon=eps)
        reset(DF)
        r = solve_neumann_fused(M, b_m, opts)
        counts = dict(DF.LAUNCHES)
        ran = sorted(k for k, v in counts.items() if v)
        rel = host_residual(M, r.solution, b_m)
        if not (r.converged and np.all(np.isfinite(r.solution))
                and r.solution.shape == b_m.shape
                and rel < max(SOLVE_RTOL, 1.5 * eps) and r.method == expect
                and ran == ([key] if key else [])):
            raise RuntimeError(f"fused n={n} eps={eps}: method={r.method} "
                               f"converged={r.converged} host rel residual "
                               f"{rel} launches {counts}")
        if key:
            launches[key] = counts[key]
        warm = warm_ms(torch, lambda: solve_neumann_fused(M, b_m, opts), 5)
        print(f"n={n} eps={eps}: ran {r.method}, iterations={r.iterations} "
              f"residual={r.residual:.3e} host f64 rel residual={rel:.3e} "
              f"launches={counts} warm solve ms "
              f"{' '.join(f'{t:.4f}' for t in warm)}", flush=True)
        if args.trace is not None and n == 768:
            profile_solve(torch, lambda: solve_neumann_fused(M, b_m, opts),
                          args.trace / "fused_solve_n768.json")
    # on no path of the port or of the JAX package (tests only)
    launches["dense_jacobi_fused"] = launches["dense_power_fused"] = 0

    phase(f"16 csr_spmm vs plain at n={N_MAIN}, B in {SPMM_WIDTHS}")
    from sublinear_tpu_torch.ops import tiled_spmm as TS
    from sublinear_tpu_torch.parallel import sharded as PS

    if A._op_kind(batch=True) != "csr" or A.op(batch=True) is not op:
        raise RuntimeError(f"the n={N_MAIN} batch routes to "
                           f"{A._op_kind(batch=True)!r}, not 'csr'")
    f32 = torch.float32
    S_lib = sparse_csr(torch, A, dev)
    errs["csr_spmm"] = []
    late["csr_spmm"] = []

    def check_spmm(label, got, want, again):
        rel = rel_err(got, want)
        errs["csr_spmm"].append((label, rel, float((got - want).abs().max())))
        print(f"  csr_spmm {label}: max rel err {rel:.3e}", flush=True)
        if not rel <= KERNEL_RTOL:
            raise RuntimeError(f"csr_spmm {label} disagrees with its plain "
                               f"version: {rel} > {KERNEL_RTOL}")
        if not torch.equal(got, again):
            raise RuntimeError(f"csr_spmm {label}: two runs differ")

    for B in SPMM_WIDTHS:
        X = torch.as_tensor(rng.standard_normal((N_MAIN, B)), dtype=f32,
                            device=dev)
        kern = lambda X=X: op.matmat(X)
        plain = lambda: K.csr_spmm_plain(op, X, op.diag)
        lib = lambda X=X: torch.sparse.mm(S_lib, X)
        Y = kern()
        check_spmm(f"matmat B={B}", Y, plain(), kern())
        lib_err = rel_err(lib(), Y)
        if not lib_err <= KERNEL_RTOL:
            raise RuntimeError(f"torch.sparse.mm disagrees with csr_spmm at "
                               f"B={B}: {lib_err}")
        cols = sorted({0, min(31, B - 1), min(32, B - 1), B - 1})
        for s in cols:
            one = K.csr_spmm(op, X[:, s:s + 1].contiguous(), op.diag)
            if not torch.equal(Y[:, s], one[:, 0]):
                raise RuntimeError(f"csr_spmm B={B}: column {s} differs from"
                                   f" the product of that column alone")
        print(f"  csr_spmm B={B}: columns {cols} equal the product of each "
              f"column alone bit for bit", flush=True)
        k_ms, p_ms, turns = in_turns(torch, kern, plain, 50)
        lib_ms = time_ms(torch, lib, 50)
        # indptr, off-diagonal indices and values, diag, X read once; Y
        # written once
        nbytes = (4 * (N_MAIN + 1) + 8 * nnz_off + 4 * N_MAIN
                  + 8 * N_MAIN * B)
        fig = Figures(f"csr_spmm matmat B={B}", kern, lib, k_ms, lib_ms,
                      nbytes, bound(nbytes, SPMM_OPS["f32"] * nnz_off * B
                                    + 2 * N_MAIN * B), 4 * B * nnz_off)
        print(f"  csr_spmm matmat B={B} ms per call: kernel {turns['kernel']}"
              f" plain {turns['plain']}; cuSPARSE SpMM (torch.sparse.mm) "
              f"{lib_ms:.5f}", flush=True)
        if B == N_RHS:
            late["csr_spmm"].insert(0, fig)
            ms["csr_spmm"], plain_ms["csr_spmm"] = k_ms, p_ms
            library_ms["csr_spmm"] = lib_ms
            bounds["csr_spmm"] = fig.bound
        else:
            late["csr_spmm"].append(fig)
    t0 = time.perf_counter()
    tiles = TS.build_tiles(A.csr)
    nnz_all = tiles.csr.indices.numel()
    print(f"  build_tiles seconds {time.perf_counter() - t0:.2f}: "
          f"{tiles.n_tiles} tiles of {tiles.T}, fill {tiles.fill:.4f}, "
          f"n_pad {tiles.n_pad}, entries {nnz_all}", flush=True)
    Xp = torch.zeros((tiles.m_pad, N_RHS), dtype=f32, device=dev)
    Xp[:N_MAIN] = torch.as_tensor(rng.standard_normal((N_MAIN, N_RHS)),
                                  dtype=f32, device=dev)
    for precise in (True, False):
        kern = lambda: TS.onehot_spmm(tiles, Xp, precise)
        plain = lambda: TS.onehot_spmm_plain(tiles, Xp, precise)
        label = f"onehot_spmm precise={precise} B={N_RHS}"
        check_spmm(label, kern(), plain(), kern())
        k_ms, p_ms, turns = in_turns(torch, kern, plain, 20)
        b_ms, b_by = bound(4 * (tiles.n_pad + 1) + 8 * nnz_all
                           + 4 * (tiles.m_pad + tiles.n_pad) * N_RHS,
                           SPMM_OPS["split" if precise else "bf16"]
                           * nnz_all * N_RHS)
        print(f"  {label} ms per call: kernel {turns['kernel']} plain "
              f"{turns['plain']}; bound {b_ms:.5f} ms ({b_by}), "
              f"{b_ms / k_ms:.3f} of it", flush=True)
    del tiles, Xp

    phase(f"17 solve_batch at n={N_MAIN} with {N_RHS} RHS, epsilon 1e-6")
    Bm = np.random.default_rng(0).standard_normal((N_MAIN, N_RHS))
    opts = slt.SolverOptions(epsilon=1e-6)
    for label, M, method, expect in (
            ("headline", A, "neumann", "neumann-batch"),
            ("SPD", S, "auto", "cg-batch")):
        reset(K)
        results = PS.solve_batch(M, Bm, opts, method=method)
        counts = dict(K.LAUNCHES)
        iters = results[0].iterations
        X = np.stack([r.solution for r in results], axis=1)
        rels = host_residuals(M, X, Bm)
        # the Neumann batch counts its seed term as iteration 1 and skips the
        # product of X0 = 0; CG multiplies X0 = 0 once
        want = iters + (expect == "cg-batch")
        if not (len(results) == N_RHS and X.shape == Bm.shape
                and np.all(np.isfinite(X)) and rels.max() < SOLVE_RTOL
                and all(r.converged and r.method == expect
                        and r.iterations == iters for r in results)
                and counts["csr_spmm"] == want and not counts["neumann_step"]):
            raise RuntimeError(
                f"solve_batch {label} {method}: methods "
                f"{sorted({r.method for r in results})} converged "
                f"{sum(r.converged for r in results)}/{len(results)} "
                f"iterations={iters} max host rel residual {rels.max()} "
                f"launches {counts} (csr_spmm expected {want})")
        if expect == "neumann-batch":
            launches["csr_spmm"] = counts["csr_spmm"]
        warm = warm_ms(torch, lambda: PS.solve_batch(M, Bm, opts,
                                                     method=method), 3)
        bop = M.op(batch=True)
        B_dev = torch.as_tensor(Bm, dtype=f32, device=dev)
        thr = (1e-6 * np.linalg.norm(Bm, axis=0)).astype(np.float32)
        run = (PS._neumann_batch_run if expect == "neumann-batch"
               else PS._cg_batch_run)
        loop = warm_ms(torch, lambda: run(bop, B_dev, thr, 1000), 3)
        print(f"{label} method={method}: ran {expect}, iterations={iters} max "
              f"host f64 rel residual={rels.max():.3e} launches={counts}; warm"
              f" solve_batch ms per batch {' '.join(f'{t:.4f}' for t in warm)}"
              f", per RHS {' '.join(f'{t / N_RHS:.5f}' for t in warm)}; the "
              f"batch loop alone (B on the card) ms "
              f"{' '.join(f'{t:.4f}' for t in loop)}", flush=True)
        del B_dev
        if expect == "neumann-batch":
            print(f"  host steps of one call, wall ms (2 runs): "
                  f"{host_steps_ms(torch, Bm, dev)} "
                  f"{host_steps_ms(torch, Bm, dev)}", flush=True)
        if args.trace is not None and expect == "neumann-batch":
            profile_solve(torch, lambda: PS.solve_batch(A, Bm, opts,
                                                        method="neumann"),
                          args.trace / "batch_neumann_n100k.json")

    phase(f"18 small-batch chain path: {N_RHS_CHAIN} RHS at n={N_MAIN}")
    B_small = Bm[:, :N_RHS_CHAIN]
    reset(K)
    results = PS.solve_batch(A, B_small, opts, method="neumann")
    counts = dict(K.LAUNCHES)
    X = np.stack([r.solution for r in results], axis=1)
    rels = host_residuals(A, X, B_small)
    if not (all(r.converged and r.method == "neumann-batch" for r in results)
            and np.all(np.isfinite(X)) and rels.max() < SOLVE_RTOL
            and counts["neumann_step"] and not counts["csr_spmm"]):
        raise RuntimeError(f"small batch: converged "
                           f"{sum(r.converged for r in results)} max host rel"
                           f" residual {rels.max()} launches {counts}")
    warm = warm_ms(torch, lambda: PS.solve_batch(A, B_small, opts,
                                                 method="neumann"), 3)
    print(f"iterations={results[0].iterations} max host f64 rel residual="
          f"{rels.max():.3e} launches={counts}; warm ms per batch "
          f"{' '.join(f'{t:.4f}' for t in warm)}", flush=True)

    phase("19 device times of the sparse products, the chains and the dense "
          "kernels (torch.profiler)")
    dev_ms = {name: [fig.report(torch) for fig in figs][0]
              for name, figs in late.items()}
    for name, fn, steps, kern in (
            ("neumann_step", chain_kernel, CHAIN_ITERS, "neumann_chain"),
            ("cg_step", lambda: K.cg_chain(sop, *cg0, CG_ITERS), CG_ITERS,
             "cg_chain")):
        whole = device_ms(torch, fn)
        alone = device_ms(torch, fn, kernel=kern)
        dev_ms[name] = None if alone is None else alone / steps
        b_ms, b_by = bounds[name]
        print(f"  {name} at n={N_MAIN}: device per step "
              f"{fmt_ms(dev_ms[name])} ms (the chain kernel alone), "
              f"{fmt_ms(None if whole is None else whole / steps)} ms (the "
              f"whole call, its copies and fills included); bound "
              f"{b_ms:.5f} ms ({b_by})", flush=True)
    for name, names in (
            ("dense_neumann_fused", "dense_neumann_kernel"),
            ("dense_neumann_fused_bf16x3", "dense_neumann_kernel"),
            ("dense_jacobi_fused", "dense_iter_kernel"),
            ("dense_power_fused", ("dense_iter_kernel", "mass_kernel"))):
        dev_ms[name], per_call = device_profile(torch, dense_fns[name],
                                                kernel=names)
        _, every = device_profile(torch, dense_fns[name])
        n, B = timed[name]
        b_ms, b_by = bounds[name]
        print(f"  {name} at n={n} B={B} iters={DENSE_ITERS}: device "
              f"{fmt_ms(dev_ms[name])} ms per call, {per_call} device "
              f"launches per call ({every} of any kernel); per call "
              f"{ms[name]:.5f} ms; bound {b_ms:.5f} ms ({b_by})", flush=True)
        if name.startswith("dense_neumann") and not per_call == every == 1:
            raise RuntimeError(f"{name}: {every} device launches per call, "
                               f"{per_call} of dense_neumann_kernel; the "
                               f"persistent kernel is one")

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        b_ms, b_by = bounds[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(ab for _, _, ab in errs[name]),
            "ms": ms[name], "plain_ms": plain_ms[name],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms.get(name),
            "device_ms": dev_ms.get(name),
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
