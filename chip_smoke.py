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
     route: dense_neumann_fused, dense_jacobi_fused and dense_power_fused
     (on a column-stochastic P^T of a seeded random graph with dangling
     nodes, alpha 0.85) at n=768, n=1536 and n=3000 (the matrix stored
     dense: 36 MB of A, more than the card's shared memory, so rows are
     read from global memory inside the persistent kernel) with B in
     {1, 4}, and dense_neumann_fused_bf16x3 at n=1536, each with iters=8;
     a warm restart of dense_neumann_fused 8 then 8; the two Neumann
     kernels with iters=0 at their path's n, Jacobi and power with iters=0
     at each n; and the time per call of each at B=1 in turns;
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
 19. the stationary solvers on the headline matrix with b = rhs(n, seed=7),
     epsilon 1e-6: method="jacobi", "gauss-seidel" and "sor" (multicolor,
     one csr_spmv per color), with the greedy coloring's colors, host
     seconds and branch, and csr_spmv launches equal to k * colors plus the
     residual checks;
 20. the walkers: walk_estimate on 10,000 rows of the headline matrix
     (default_rng(11)), SolverOptions(epsilon=1e-3, num_walks=64), for each
     strategy, and control variates on 1,000 of the rows, each held to the
     exact solve (Neumann at 1e-6): 99% of the entries within 5 standard
     errors; then solve(method="random-walk") on the canonical n=1000
     matrix;
 21. hybrid on the headline matrix at epsilon 1e-6 (converged), and the
     forcing case: the tridiagonal matrix + 0.5 I at n=100k with
     max_iterations=20 and max_walk_length=64, whose walker phase must run;
 22. BMSSP on the headline matrix with 20 nonzeros in b (default_rng(0)
     positions): the Bellman-Ford path, shortest_paths held to a host
     multi-source Dijkstra (heapq) at rtol 1e-5, and batched_distances from
     64 sources, two of its rows held to Dijkstra the same way;
 23. the serving solvers: solve_refined at epsilon 1e-12 with the f64 device
     residual (host f64 relative residual <= 1e-12), PreparedSolver(A,
     "neumann") over 10 right-hand sides against solve() (the same
     launches as solve()'s, counted apart) and
     PreparedSolver(S, "cg") on the SPD matrix, streaming_solve (CG,
     chunk_iters=10) on the SPD matrix with one DeltaUpdate queued after the
     first chunk, and solve_streaming on the n=1M matrix in >= 8 row panels,
     the panel product held to CsrOperator.matvec;
 24. the graph layer on a web-scale digraph (1M nodes, 5M uniform edges
     from default_rng(7), the size of SNAP's web-Google): pagerank (damping
     0.85, epsilon 1e-6) and personalized_pagerank from 20 nodes, each held
     to an f64 scipy power iteration within the bound of its residual, with
     csr_spmv launches 1 + 6 per 5-step block and the host set-up (P^T,
     out-degrees, pack_csr) timed apart from the loop; pagerank on an
     R-MAT digraph of the same n and edge count (Graph500's a=0.57,
     b=c=0.19, ids scrambled), whose hubs give P^T rows past
     SPMV_LONG_ROW entries (csr_spmv's one-row blocks), and csr_spmv on
     that P^T against cuSPARSE (device times and bound in phase 28);
     degroot_consensus
     (100 csr_spmv launches), friedkin_johnsen (neumann_step; host f64
     residual of I - (1-s) W) and influence_propagation;
 25. the queries on the headline matrix: estimate_functional (t from
     default_rng(11)) within 1e-3 max(|t.x|, 1) + its error bound of t.x,
     estimate_entry by backward push and by Neumann (the inverse entry) at
     four entries, each within its half-width and the 1e-6 solve's bound
     and each launching what one adjoint push or Neumann solve at its
     epsilon 1e-4 launches,
     estimate_entries by random walk on 10,000 rows x 64 walks (99% within
     5 standard errors), and the temporal lead at n=1000 (DIA route);
 26. on the connected undirected graph (a ring of 100k nodes plus 400k
     uniform edges, as graph.flow.weighted_laplacian builds it):
     effective_resistance (cg_step; host f64 residual), electrical_network
     and min_cost_flow at epsilon 1e-8 (their converged flags; host f64
     residual below F32_CG_LEVEL, and the same CG run by the port on the
     CPU in f32, which must reach it too, and in f64), closeness on the first 256 nodes equal
     to the BFS levels bit for bit, betweenness from 8 sources against the
     host Brandes at rtol 1e-5 and timed at 256, detect_communities;
 27. the utilities on the card: record_solve and ProfileLog of phase 4's
     solve (backend "cuda"), memory_info, profile_memory around a PageRank
     of phase 24's graph (peak device bytes), resume from a saved
     checkpoint of phase 4's solve and update_rhs with a 20-entry delta;
 28. the figures of csr_spmv (phases 3 and 6) and csr_spmm (phase 16, f32)
     with their device times, the device times of the two chain kernels at
     n=100k (neumann_step per step of phase 5's chain, cg_step per step of
     phase 8's), and the device time and device launches per call of the
     four dense kernels at their timed shapes (raising unless each call is
     one launch of the persistent dense_fused_kernel).  They come last
     because a torch.profiler window slows the host-bound solves that
     follow it in the same process (BiCGSTAB, CG on the ELL route);
 29. the CLI on the headline matrix, written as .mtx with rhs(n, seed=7) as
     JSON, through cli.main in this process: solve --method neumann and
     --method conjugate-gradient (the SPD form, as JSON), verify, analyze,
     estimate --method neumann, benchmark --sizes 1000,10000,100000
     --density 1e-4 --method neumann, pagerank on a 100k-node digraph of
     500k edges from default_rng(7), convert .mtx -> .json -> .mtx
     (byte-identical), a non-DD input (exit 2, E001); and solve once as
     `python -m sublinear_tpu_torch.interfaces.cli` in a subprocess;
 30. the MCP server: serve-mcp in a subprocess over stdio (initialize,
     tools/list, tools/call solve with the headline matrix on one ~38 MB
     line, backend "cuda"), then in-process through
     MCPServer.handle_request: solve, batchSolve with 128 RHS (csr_spmm)
     and with 20 (the serialized chains), sublinear_solver_stream and
     solver_verification on its session, pageRank and effectiveResistance
     on phase 26's graph, estimateEntry by Neumann;
 31. the HTTP server (make_server in a thread): /health (backend "cuda",
     1 device), a CG job on the SPD n=100k matrix POSTed to
     /api/v1/solve-stream and its chunk stream read to completed (every
     in-stream verification event passing), solve then update_rhs on /ws
     (an SPD n=20k matrix: the payload stays under the WebSocket's 16 MB),
     and a SwarmNode joined over /ws/swarm with a solve routed to it;
 32. benchmarks.py: bench_solve_scaling_reference_sizes (1k/10k/100k),
     bench_spmv (n=100k, 100 entries per row, the ELL route) beside its
     12 B/nnz bound at 3.35 TB/s, bench_batch_solve at 128 RHS,
     accuracy_validation(sizes=(50, 100, 200)) (any error but
     NotDiagonallyDominantError fails the run) and dashboard(full=False);
 33. the temporal models at the shipped configs' width (window 256, hidden
     32), from the JSON twins of configs/*.yaml: nn-latency through cli.main
     for System A (GRU, int8) and System B at 1000 ticks (stages and ticks
     as CUDA graphs: the staged stages' and the streaming tick's
     P50/P99/P99.9, meets_targets), beside the same predictor eager (50
     staged predicts, 1000 ticks) and the kernels per tick of both forms
     from torch.profiler windows of 10 ticks; train through cli.main on the
     A config and the built-in series (epochs, first and last loss,
     val_loss, ms per graphed train step; the loss must fall) beside the
     eager step's ms; train_system_b on the B config over 8192 windows of that
     series with 1024 held out, select_samples' window launching exactly
     what the bare pagerank launches on its graph (csr_spmv alone; the
     graph must take the "csr" route), the scores held to the f64 oracle,
     N samples in epochs 0-1 then 1000, and the gated model beating the
     Kalman prior alone on the held-out windows; the GRU and TCN ticks
     against the full forwards (rtol 1e-5) and int8 against f32 (0.05).

Phases 19-27 and 29-33 each set the kernels' launch counts to 0 right
before they drive a path and print the counts right after it; oracles and
checks that launch run outside those windows.  In phases 29-32 each entry
point's count must equal what the bare library call launches on the same
input, counted the same way (an entry point adds host work, no device
work); the Neumann and CG solutions that come back through JSON must equal
the library call's bit for bit; each window prints its host ms and its
device ms (torch.profiler's device trace).  The kernels line's "launches"
is the sum of every counted path: phase 4's solve (csr_spmv,
neumann_step), phase 9's cg_step, phase 15's two fused solves, phase 17's
Neumann batch (csr_spmm) and every window of phases 19-27 and 29-33.
Phases 24-33 print the card's name and power limit in their headers; the
script's own seconds come before the kernels line.

Beside each kernel's time the script computes its bound (the least time the
card could take: the bytes the function must move at 3.35 TB/s, or its
operations at the card's peak for their type, whichever is larger) and, for
csr_spmv and csr_spmm, times one PyTorch call that computes the same
function (a CUDA torch.sparse_csr_tensor of A times x, or times X with
torch.sparse.mm) as a yardstick the port never calls.  The figures of those
two kernels: the time per back-to-back call (CUDA events, host work
included), the device time alone (torch.profiler over a window of
back-to-back calls, phase 28), both also for the yardstick, the bound and
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
N_WALK_ROWS, N_CV_ROWS = 10_000, 1_000  # bench.py's MC entry row
WALKS = 64
WALK_SE = 5             # an estimate within 5 standard errors (+1e-6) ...
WALK_SHARE = 0.99       # ... for at least 99% of the entries
N_BMSSP_SOURCES, N_BATCH_SOURCES = 20, 64
DIJKSTRA_RTOL = 1e-5
N_PREPARED = 10
PREPARED_RTOL = 1e-6
MIN_PANELS = 8
N_WEB, E_WEB = 1_000_000, 5_000_000  # the web-scale digraph (web-Google size)
RMAT_SCALE, RMAT_A, RMAT_B = 20, 0.57, 0.19  # Graph500's R-MAT (b = c)
N_UND, E_UND = 100_000, 400_000      # the connected undirected graph
E_DIGRAPH = 500_000                  # phase 29's digraph on N_UND nodes
N_WS, DENSITY_WS = 20_000, 2.5e-4    # a payload under the WebSocket's 16 MB
DAMPING = 0.85
N_PPR_SEEDS = 20
DEGROOT_STEPS = 100
FJ_SUSCEPTIBILITY = 0.5
N_ENTRY_ROWS = 4        # estimate_entry rows of each deterministic method
N_CLOSENESS = 256       # closeness on the first 256 nodes (one chunk)
N_BC_CHECK, N_BC_TIMED = 8, 256  # betweenness sources: held / timed
BC_RTOL = 1e-5
F32_CG_LEVEL = 1e-4     # the true relative residual an f32 CG reaches on the
#                         grounded flow systems (its recurrence runs lower);
#                         phase 26 prints the same CG's level on the CPU
N_DELTA = 20            # entries of update_rhs's delta
DEVICE_REPS = 50        # back-to-back calls in a profiled window
N_TICKS = 1000          # nn-latency's default ticks
N_EAGER_STAGED, N_EAGER_STEPS = 50, 7  # the eager forms timed beside
N_SYS_B, N_SYS_B_VAL = 8192, 1024  # train_system_b's windows, held out
N_PARITY_TICKS = 20
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
    n, nnz = op.shape[0], op.indices.numel()
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
    csr_spmm bit for bit.  Returns the ``Figures`` phase 28 prints."""
    n, nnz = op.shape[0], op.indices.numel()
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


def dijkstra(csr, sources):
    """Multi-source Dijkstra (heapq, f64) over A's graph: edge i -> j of
    cost 1/|a_ij| for each stored off-diagonal entry, the graph BMSSP's
    Bellman-Ford relaxes through the in-edges."""
    import heapq

    indptr, indices, data = (csr.indptr.tolist(), csr.indices.tolist(),
                             np.abs(csr.data).tolist())
    dist = [math.inf] * csr.shape[0]
    heap = [(0.0, int(s)) for s in sources]
    for _, s in heap:
        dist[s] = 0.0
    heapq.heapify(heap)
    while heap:
        d, u = heapq.heappop(heap)
        if d > dist[u]:
            continue
        for k in range(indptr[u], indptr[u + 1]):
            v = indices[k]
            if v != u:
                nd = d + 1.0 / max(data[k], 1e-30)
                if nd < dist[v]:
                    dist[v] = nd
                    heapq.heappush(heap, (nd, v))
    return np.asarray(dist)


def check_distances(dist, ref, label):
    """Raise unless ``dist`` reaches exactly the nodes ``ref`` reaches and
    agrees with it there within DIJKSTRA_RTOL."""
    reach = np.isfinite(ref)
    if not np.array_equal(dist < 1e29, reach):
        raise RuntimeError(f"{label}: reached {int((dist < 1e29).sum())} "
                           f"nodes, Dijkstra {int(reach.sum())}")
    err = float(np.max(np.abs(dist[reach] - ref[reach])
                       / np.maximum(np.abs(ref[reach]), 1e-30)))
    if not err <= DIJKSTRA_RTOL:
        raise RuntimeError(f"{label}: max rel diff from Dijkstra {err}")
    return int(reach.sum()), err


def counted(K):
    """The launch counts of the CSR kernels as a compact dict."""
    return {k: v for k, v in K.LAUNCHES.items() if v}


def path_counts(K, launches):
    """counted(K) of the path window just run (counts set to 0 right before
    the path and read right after it; nothing else in the window launches a
    kernel: oracles run outside it), added to ``launches``, the kernels
    line's totals."""
    counts = counted(K)
    for name, v in counts.items():
        launches[name] += v
    return counts


def solver_family(torch, slt, K, A, b, S, A_big, b_big, launches):
    """Phases 19-23: the rest of the solver family on the card."""
    from sublinear_tpu_torch import native
    from sublinear_tpu_torch.formats import streaming as FS
    from sublinear_tpu_torch.solvers import bmssp as BM
    from sublinear_tpu_torch.solvers import jacobi as SJ
    from sublinear_tpu_torch.solvers import random_walk as RW
    from sublinear_tpu_torch.solvers import refine as RF
    from sublinear_tpu_torch.solvers.hybrid import solve_hybrid
    from sublinear_tpu_torch.solvers.prepared import PreparedSolver
    from sublinear_tpu_torch.solvers.streaming import (StreamControl,
                                                       streaming_solve)

    n = A.shape[0]
    phase(f"19 stationary solvers at n={n}: jacobi, gauss-seidel, sor")
    t0 = time.perf_counter()
    colors = SJ.greedy_coloring(A)
    color_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    SJ.greedy_coloring(A)  # A^T cached: what every GS/SOR solve repeats
    again_s = time.perf_counter() - t0
    branch = ("native" if n > SJ.NATIVE_COLORING_MIN_N and native.available()
              else "numpy")
    n_colors = int(colors.max()) + 1
    print(f"greedy coloring: {n_colors} colors, the {branch} branch, "
          f"{color_s:.4f} host seconds on the first call (A^T built), "
          f"{again_s:.4f} on the next", flush=True)
    for method in ("jacobi", "gauss-seidel", "sor"):
        reset(K)
        r, rel = check_solve(slt, A, b, f"{method} n={n}", method)
        counts = path_counts(K, launches)
        per = 1 if method == "jacobi" else n_colors
        # one product per color and sweep, one per residual check
        want = r.iterations * per + r.iterations // 5 + 1
        if counts != {"csr_spmv": want}:
            raise RuntimeError(f"{method}: launches {counts}, csr_spmv "
                               f"expected {want}")
        warm = warm_ms(torch, lambda: slt.solve(A, b, method=method,
                                                epsilon=1e-6), 3)
        print(f"{method}: ran {r.method}, iterations={r.iterations} "
              f"residual={r.residual:.3e} host f64 rel residual={rel:.3e} "
              f"launches={counts} (k * {per} + k / 5 + 1) warm solve ms "
              f"{' '.join(f'{t:.4f}' for t in warm)}", flush=True)

    phase(f"20 walkers: walk_estimate on {N_WALK_ROWS} rows at n={n}")
    exact = slt.solve(A, b, method="neumann", epsilon=1e-6).solution
    rows = np.random.default_rng(11).integers(0, n, N_WALK_ROWS)
    cases = [(s, {"sampling": s}, rows) for s in
             ("importance", "uniform", "stratified", "qmc", "adaptive")]
    cases.append(("control-variates",
                  {"variance_reduction": "control-variates"},
                  rows[:N_CV_ROWS]))
    for label, kw, sel in cases:
        opts = slt.SolverOptions(epsilon=1e-3, num_walks=WALKS, **kw)
        RW.walk_estimate(A, b, sel[:100], opts)  # tables built, warm
        reset(K)
        est, var, steps = RW.walk_estimate(A, b, sel, opts)
        counts = path_counts(K, launches)
        se = np.sqrt(np.maximum(var, 0.0) / WALKS)
        share = float(np.mean(np.abs(est - exact[sel]) <= WALK_SE * se + 1e-6))
        if not (np.all(np.isfinite(est)) and est.shape == sel.shape
                and share >= WALK_SHARE):
            raise RuntimeError(f"walk_estimate {label}: {share:.4f} of the "
                               f"entries within {WALK_SE} standard errors")
        if label == "control-variates" and counts != {
                "csr_spmv": RW.CV_HEAD_STEPS}:
            raise RuntimeError(f"control variates: launches {counts}")
        warm = warm_ms(torch, lambda: RW.walk_estimate(A, b, sel, opts), 2)
        print(f"{label}: {sel.size} entries, {steps} steps, {share:.4f} within"
              f" {WALK_SE} SE of the exact solve, mean SE {se.mean():.3e}, "
              f"launches {counts}; warm ms "
              f"{' '.join(f'{t:.3f}' for t in warm)}, us per entry "
              f"{' '.join(f'{t / sel.size * 1e3:.3f}' for t in warm)}",
              flush=True)
    A1 = slt.generate("random-sparse", 1000, seed=7, density=0.001)
    b1 = slt.rhs(1000, seed=7)
    r = slt.solve(A1, b1, method="random-walk", raise_on_fail=False)
    (rw_ms,) = warm_ms(torch, lambda: slt.solve(
        A1, b1, method="random-walk", raise_on_fail=False), 1)
    rel = host_residual(A1, r.solution, b1)
    if not (r.method == "random-walk" and np.all(np.isfinite(r.solution))
            and rel < 1e-2):
        raise RuntimeError(f"random-walk n=1000: method={r.method} host rel "
                           f"residual {rel}")
    walks = RW.default_num_walks(slt.SolverOptions())
    print(f"solve(method='random-walk') n=1000: {walks} walks per entry, "
          f"steps={r.iterations} converged={r.converged} host f64 rel "
          f"residual={rel:.3e} warm ms {rw_ms:.1f}", flush=True)

    phase(f"21 hybrid at n={n}")
    reset(K)
    r, rel = check_solve(slt, A, b, f"hybrid n={n}", "hybrid")
    counts = path_counts(K, launches)
    if not counts.get("csr_spmv"):
        raise RuntimeError(f"hybrid: launches {counts}")
    warm = warm_ms(torch, lambda: slt.solve(A, b, method="hybrid",
                                            epsilon=1e-6), 3)
    phases = [(q["phase"], q["iterations"], q.get("switch_reason"))
              for q in r.phases]
    print(f"hybrid headline: iterations={r.iterations} host f64 rel "
          f"residual={rel:.3e} phases={phases} launches={counts} warm "
          f"solve ms {' '.join(f'{t:.4f}' for t in warm)}", flush=True)
    T = slt.Matrix(slt.generate("tridiagonal", n).csr.add_diagonal(0.5))
    b_t = slt.rhs(n, seed=3)
    opts = slt.SolverOptions(epsilon=1e-6, max_iterations=20,
                             max_walk_length=64)
    reset(K)
    r = solve_hybrid(T, b_t, opts, raise_on_fail=False)
    counts = path_counts(K, launches)
    (secs,) = warm_ms(torch, lambda: solve_hybrid(T, b_t, opts,
                                                  raise_on_fail=False), 1)
    names = [q["phase"] for q in r.phases]
    rel = host_residual(T, r.solution, b_t)
    if not ("random-walk" in names and np.all(np.isfinite(r.solution))
            and r.residual < float(np.linalg.norm(b_t))):
        raise RuntimeError(f"hybrid forcing case: phases {r.phases}")
    mc = r.phases[names.index("random-walk")]
    print(f"hybrid forcing case (tridiagonal + 0.5 I, route "
          f"{T._op_kind()}): phases {names}, push "
          f"{r.phases[0]['iterations']} iterations "
          f"({r.phases[0]['switch_reason']}), walker rounds "
          f"{mc['iterations']} blends {mc['blends']}, residual "
          f"{r.residual:.3e} (host f64 rel {rel:.3e}) converged="
          f"{r.converged} launches {counts} warm ms {secs:.1f}", flush=True)
    del T, b_t

    phase(f"22 BMSSP at n={n}")
    rng = np.random.default_rng(0)
    src = rng.choice(n, N_BMSSP_SOURCES, replace=False)
    b_s = np.zeros(n)
    b_s[src] = rng.uniform(0.5, 1.5, N_BMSSP_SOURCES)
    reset(K)
    t0 = time.perf_counter()
    r = slt.solve(A, b_s, method="bmssp", raise_on_fail=False)
    first_s = time.perf_counter() - t0
    counts = path_counts(K, launches)
    warm = warm_ms(torch, lambda: slt.solve(A, b_s, method="bmssp",
                                            raise_on_fail=False), 3)
    if r.method != "bmssp" or not np.all(np.isfinite(r.solution)):
        raise RuntimeError(f"bmssp: method {r.method}")
    dist, x, sweeps = BM.shortest_paths(A, src, b_s[src])
    t0 = time.perf_counter()
    ref = dijkstra(A.csr, src)
    dj_s = time.perf_counter() - t0
    reached, err = check_distances(dist, ref, "shortest_paths")
    print(f"solve(method='bmssp'): ran {r.method}, {r.iterations} sweeps, "
          f"first call {first_s * 1e3:.1f} ms (the in-edge tables built), "
          f"warm ms {' '.join(f'{t:.3f}' for t in warm)}, launches {counts}; "
          f"shortest_paths "
          f"{sweeps} sweeps, {reached} nodes reached, max rel diff from "
          f"Dijkstra {err:.2e} (Dijkstra {dj_s:.2f} host s)", flush=True)
    srcs = np.random.default_rng(1).choice(n, N_BATCH_SOURCES, replace=False)
    D = BM.batched_distances(A, srcs)
    warm = warm_ms(torch, lambda: BM.batched_distances(A, srcs), 2)
    for j in (0, N_BATCH_SOURCES - 1):
        reached, err = check_distances(D[j], dijkstra(A.csr, [srcs[j]]),
                                       f"batched_distances source {j}")
        print(f"batched_distances from {N_BATCH_SOURCES} sources: row {j} "
              f"reaches {reached} nodes, max rel diff from Dijkstra "
              f"{err:.2e}", flush=True)
    print(f"batched_distances from {N_BATCH_SOURCES} sources: warm ms "
          f"{' '.join(f'{t:.3f}' for t in warm)}", flush=True)

    phase("23 serving solvers: solve_refined, PreparedSolver, "
          "streaming_solve, solve_streaming")
    inner = {"solves": 0}
    plain_solve = RF.solve

    def counting_solve(*a, **kw):
        inner["solves"] += 1
        return plain_solve(*a, **kw)

    RF.solve = counting_solve
    try:
        reset(K)
        r = RF.solve_refined(A, b, slt.SolverOptions(epsilon=1e-12))
        counts = path_counts(K, launches)
    finally:
        RF.solve = plain_solve
    rel = host_residual(A, r.solution, b)
    warm = warm_ms(torch, lambda: RF.solve_refined(
        A, b, slt.SolverOptions(epsilon=1e-12)), 3)
    if not (r.converged and rel <= 1e-12 and counts.get("neumann_step")):
        raise RuntimeError(f"solve_refined: converged={r.converged} host rel"
                           f" residual {rel} launches {counts}")
    print(f"solve_refined: ran {r.method}, {inner['solves']} refinements, "
          f"{r.iterations} inner iterations, device f64 residual "
          f"{r.residual / np.linalg.norm(b):.3e} relative, host f64 "
          f"{rel:.3e}, launches {counts}, warm ms "
          f"{' '.join(f'{t:.3f}' for t in warm)}", flush=True)
    B = np.random.default_rng(5).standard_normal((n, N_PREPARED))
    reset(K)
    wants = [slt.solve(A, B[:, j], method="neumann")
             for j in range(N_PREPARED)]
    want_counts = counted(K)  # solve()'s, the oracle's: not the path's
    reset(K)
    ps = PreparedSolver(A, "neumann")
    built = path_counts(K, launches)  # its warm-up solve of b = 0
    reset(K)
    gots = [ps.solve(B[:, j]) for j in range(N_PREPARED)]
    counts = path_counts(K, launches)
    worst = 0.0
    for j, (got, want) in enumerate(zip(gots, wants)):
        diff = float(np.abs(got.solution - want.solution).max()
                     / np.abs(want.solution).max())
        worst = max(worst, diff)
        if not (got.converged and got.iterations == want.iterations
                and diff <= PREPARED_RTOL):
            raise RuntimeError(f"PreparedSolver rhs {j}: iterations "
                               f"{got.iterations} vs {want.iterations}, rel "
                               f"diff {diff}")
    if not (counts.get("neumann_step") and counts == want_counts):
        raise RuntimeError(f"PreparedSolver: launches {counts}, solve()'s "
                           f"{want_counts}")
    bj = B[:, 0]
    prep = warm_ms(torch, lambda: ps.solve(bj), 5)
    plain = warm_ms(torch, lambda: slt.solve(A, bj, method="neumann"), 5)
    print(f"PreparedSolver(neumann): {N_PREPARED} RHS, {got.iterations} "
          f"iterations each, max rel diff from solve() {worst:.2e}, launches "
          f"{counts} (those of the {N_PREPARED} solve() calls; the "
          f"constructor's {built}); warm ms per prepared solve "
          f"{' '.join(f'{t:.4f}' for t in prep)}, per solve() "
          f"{' '.join(f'{t:.4f}' for t in plain)}", flush=True)
    reset(K)
    pcg = PreparedSolver(S, "cg")
    r = pcg.solve(b)
    rel = host_residual(S, r.solution, b)
    counts = path_counts(K, launches)
    if not (r.converged and rel < SOLVE_RTOL and counts.get("cg_step")):
        raise RuntimeError(f"PreparedSolver(cg): rel {rel} launches {counts}")
    prep = warm_ms(torch, lambda: pcg.solve(b), 5)
    print(f"PreparedSolver(cg) on the SPD matrix: {r.iterations} iterations,"
          f" host f64 rel residual {rel:.3e}, launches {counts}, warm ms "
          f"{' '.join(f'{t:.4f}' for t in prep)}", flush=True)
    def stream():
        control, chunks = StreamControl(), []
        for i, ch in enumerate(streaming_solve(
                S, b, slt.SolverOptions(), method="conjugate-gradient",
                chunk_iters=10, control=control)):
            chunks.append(ch)
            if i == 0:
                control.push_delta([0, 1], [0.5, -0.5])
        return chunks

    reset(K)
    out = stream()
    counts = path_counts(K, launches)
    warm = warm_ms(torch, stream, 3)
    chunks = [(c.iteration, c.converged, c.rhs_version, f"{c.residual:.3e}")
              for c in out]
    last = out[-1]
    b2 = b.copy()
    b2[[0, 1]] += [0.5, -0.5]
    rel = host_residual(S, last.solution, b2)
    if not (last.converged and last.rhs_version == 1 and rel < SOLVE_RTOL
            and counts.get("csr_spmv")):
        raise RuntimeError(f"streaming_solve: chunks {chunks} rel {rel}")
    print(f"streaming_solve (CG, chunk_iters=10, one delta after chunk 1): "
          f"chunks (iteration, converged, rhs_version, residual) {chunks}; "
          f"host f64 rel residual to the updated b {rel:.3e}; launches "
          f"{counts}; warm ms {' '.join(f'{t:.3f}' for t in warm)}",
          flush=True)
    K_row = int(A_big.csr.row_nnz().max())
    budget = K_row * 8 * (A_big.shape[0] // MIN_PANELS // 128 * 128)
    t0 = time.perf_counter()
    sop = FS.StreamingOperator(A_big.csr, budget)
    build_s = time.perf_counter() - t0
    if sop.n_panels < MIN_PANELS:
        raise RuntimeError(f"{sop.n_panels} panels < {MIN_PANELS}")
    xs = torch.as_tensor(np.random.default_rng(4).standard_normal(
        A_big.shape[0]), dtype=torch.float32, device=A_big.device)
    reset(K)
    t0 = time.perf_counter()
    y = sop.matvec_device(xs)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = path_counts(K, launches)
    if counts != {"csr_spmv": sop.n_panels}:
        raise RuntimeError(f"panel product launches {counts}")
    err = rel_err(y, A_big.op().matvec(xs))
    if not err <= KERNEL_RTOL:
        raise RuntimeError(f"panel product vs CsrOperator.matvec: {err}")
    panel_ms = time_ms(torch, lambda: sop.matvec_device(xs), 5)
    reset(K)
    t0 = time.perf_counter()
    r = FS.solve_streaming(A_big, b_big, panel_budget=budget)
    secs = time.perf_counter() - t0
    rel = host_residual(A_big, r.solution, b_big)
    counts = path_counts(K, launches)
    if not (r.converged and r.method == "neumann-streaming"
            and rel < SOLVE_RTOL):
        raise RuntimeError(f"solve_streaming: converged={r.converged} rel "
                           f"{rel}")
    print(f"solve_streaming n={A_big.shape[0]}: {sop.n_panels} panels "
          f"(panel_budget {budget} B, max row {K_row}) built in {build_s:.3f} "
          f"s, first product {first_s * 1e3:.1f} ms (row blocks cut), panel "
          f"product vs CsrOperator.matvec max rel err {err:.3e}, "
          f"{panel_ms:.3f} ms per warm streamed product; iterations={r.iterations} host f64 rel "
          f"residual {rel:.3e} wall {secs * 1e3:.1f} ms launches {counts}",
          flush=True)


def digraph(slt, n, edges):
    """A uniform digraph: n nodes, ``edges`` directed edges from
    default_rng(SEED), self-loops dropped, duplicates summed, weights 1.
    At N_WEB, E_WEB it is the web-scale digraph."""
    rng = np.random.default_rng(SEED)
    r, c = rng.integers(0, n, edges), rng.integers(0, n, edges)
    keep = r != c
    return slt.Matrix.from_coo(r[keep], c[keep], np.ones(int(keep.sum())),
                               (n, n))


def rmat_graph(slt):
    """The skewed digraph: E_WEB R-MAT edges with Graph500's parameters
    (a=0.57, b=c=0.19) over 2^RMAT_SCALE ids from default_rng(SEED), the ids
    scrambled by a seeded permutation as Graph500 does, the edges with an
    end at or past N_WEB and the self-loops dropped, duplicates summed,
    weights 1.  Hubs of in-degree in the thousands, as a web graph has."""
    rng = np.random.default_rng(SEED)
    m = int(E_WEB * 1.25)  # ~9% of the edges have an end past N_WEB
    r = np.zeros(m, dtype=np.int64)
    c = np.zeros(m, dtype=np.int64)
    for bit in range(RMAT_SCALE):
        u = rng.random(m)
        # quadrants a (0,0), b (0,1), c (1,0), d (1,1)
        r |= (u >= RMAT_A + RMAT_B).astype(np.int64) << bit
        c |= (((u >= RMAT_A) & (u < RMAT_A + RMAT_B))
              | (u >= RMAT_A + 2 * RMAT_B)).astype(np.int64) << bit
    perm = rng.permutation(1 << RMAT_SCALE)
    r, c = perm[r], perm[c]
    keep = np.flatnonzero((r < N_WEB) & (c < N_WEB) & (r != c))[:E_WEB]
    if keep.size != E_WEB:
        raise RuntimeError(f"R-MAT kept {keep.size} edges < {E_WEB}")
    return slt.Matrix.from_coo(r[keep], c[keep], np.ones(keep.size),
                               (N_WEB, N_WEB))


def pagerank_oracle(csr, v, alpha=DAMPING):
    """tests/test_graph.py's power iteration in f64 with scipy.sparse, run
    until the l1 change is below 1e-15; returns (x*, P^T, dangling mask)."""
    import scipy.sparse as sp

    A = sp.csr_matrix((csr.data, csr.indices, csr.indptr), shape=csr.shape)
    out = np.asarray(A.sum(axis=1)).ravel()
    dang = out == 0
    PT = (sp.diags(np.where(dang, 0.0, 1.0 / np.where(dang, 1.0, out))) @ A
          ).T.tocsr()
    x = v.copy()
    for _ in range(2000):
        x_new = (1 - alpha) * v + alpha * (PT @ x + x[dang].sum() * v)
        done = np.abs(x_new - x).sum() < 1e-15
        x = x_new
        if done:
            break
    return x / x.sum(), PT, dang


def check_pagerank(r, v, oracle, label):
    """Raise unless the scores sum to 1 within 1e-5 and lie within the bound
    of the reported residual of the f64 oracle: ||x - x*||_2 <= (res + f32
    rounding) / (1 - alpha), with 16 f32 roundings of ||x*||_2 per step, and
    in l1 (P^T column-stochastic, so exact) by the host f64 residual of
    the returned scores."""
    x_star, PT, dang = oracle
    x = r.scores
    err2 = float(np.linalg.norm(x - x_star))
    rounding = 16 * float(np.finfo(np.float32).eps) * np.linalg.norm(x_star)
    bound2 = (r.residual + rounding) / (1 - DAMPING)
    step = (1 - DAMPING) * v + DAMPING * (PT @ x + x[dang].sum() * v)
    err1 = float(np.abs(x - x_star).sum())
    bound1 = float(np.abs(step - x).sum()) / (1 - DAMPING) + 1e-12
    total = float(x.sum())
    if not (r.converged and np.all(np.isfinite(x)) and abs(total - 1) < 1e-5
            and err2 <= bound2 and err1 <= bound1):
        raise RuntimeError(f"{label}: converged={r.converged} sum {total} "
                           f"l2 err {err2} > {bound2} or l1 err {err1} > "
                           f"{bound1}")
    return (f"iterations={r.iterations} residual={r.residual:.3e} "
            f"sum {total:.9f}; from the f64 oracle l2 {err2:.3e} (bound "
            f"{bound2:.3e}), l1 {err1:.3e} (bound {bound1:.3e})")


def graph_phase(torch, slt, K, launches, smi):
    """Phase 24: PageRank on the web-scale and the R-MAT graph, and the
    social dynamics on the web-scale graph, which it returns for phase 27
    with the figures of csr_spmv on the R-MAT P^T for phase 28."""
    from sublinear_tpu_torch import graph as G
    from sublinear_tpu_torch.graph.pagerank import (_transition_matrix,
                                                    pagerank_inputs,
                                                    pagerank_run)

    phase(f"24 PageRank at n={N_WEB} ({E_WEB} uniform edges; {smi})")
    t0 = time.perf_counter()
    W = digraph(slt, N_WEB, E_WEB)
    out_deg = W.csr.row_nnz()
    print(f"graph: {W.nnz} edges, {int((out_deg == 0).sum())} dangling nodes, "
          f"built in {time.perf_counter() - t0:.2f} host s", flush=True)
    reset(K)
    r = G.pagerank(W, damping=DAMPING, epsilon=1e-6)
    counts = path_counts(K, launches)
    blocks = r.iterations // 5
    if counts != {"csr_spmv": 1 + 6 * blocks}:
        raise RuntimeError(f"pagerank: launches {counts}, csr_spmv expected "
                           f"1 + 6 * {blocks}")
    v = np.full(N_WEB, 1.0 / N_WEB)
    t0 = time.perf_counter()
    oracle = pagerank_oracle(W.csr, v)
    oracle_s = time.perf_counter() - t0
    print(f"pagerank: {check_pagerank(r, v, oracle, 'pagerank')}; launches "
          f"{counts} (1 + 6 per 5-step block); oracle {oracle_s:.2f} host s",
          flush=True)
    # the host set-up apart from the loop: P^T, out-degrees and pack_csr
    # (the graph's first call builds them), then a call that finds them
    W._pagerank.clear()
    setup = []
    for _ in range(2):
        t0 = time.perf_counter()
        opT, v_t, dang = pagerank_inputs(W)
        torch.cuda.synchronize()
        setup.append(time.perf_counter() - t0)
    if type(opT).__name__ != "CsrOperator":
        raise RuntimeError(f"P^T takes {type(opT).__name__}, not the csr route")
    loop = warm_ms(torch, lambda: pagerank_run(opT, v_t, dang, DAMPING, 1e-6,
                                               1000), 3)
    whole = warm_ms(torch, lambda: G.pagerank(W), 2)
    print(f"pagerank host set-up s (build, cached) "
          f"{' '.join(f'{t:.3f}' for t in setup)}; "
          f"iteration loop warm ms {' '.join(f'{t:.3f}' for t in loop)}; "
          f"whole call ms {' '.join(f'{t:.1f}' for t in whole)}", flush=True)

    t0 = time.perf_counter()
    Wr = rmat_graph(slt)
    build_s = time.perf_counter() - t0
    # P^T's row lengths are the in-degrees
    in_deg = np.bincount(Wr.csr.indices, minlength=N_WEB)
    n_long = int((in_deg > K.SPMV_LONG_ROW).sum())
    if not n_long:
        raise RuntimeError(f"R-MAT: no in-degree past {K.SPMV_LONG_ROW}")
    print(f"R-MAT graph (a={RMAT_A}, b=c={RMAT_B}): {Wr.nnz} edges, "
          f"{int((Wr.csr.row_nnz() == 0).sum())} dangling nodes, max "
          f"in-degree {int(in_deg.max())}, {n_long} rows of P^T past "
          f"{K.SPMV_LONG_ROW} entries (csr_spmv's one-row blocks), built in "
          f"{build_s:.2f} host s", flush=True)
    reset(K)
    rr = G.pagerank(Wr, damping=DAMPING, epsilon=1e-6)
    counts = path_counts(K, launches)
    if counts != {"csr_spmv": 1 + 6 * (rr.iterations // 5)}:
        raise RuntimeError(f"pagerank R-MAT: launches {counts}")
    print(f"pagerank R-MAT: "
          f"{check_pagerank(rr, v, pagerank_oracle(Wr.csr, v), 'R-MAT')}; "
          f"launches {counts}; top score {rr.scores.max():.3e}", flush=True)
    opT, v_t, dang = pagerank_inputs(Wr)
    if type(opT).__name__ != "CsrOperator":
        raise RuntimeError(f"R-MAT P^T takes {type(opT).__name__}")
    loop = warm_ms(torch, lambda: pagerank_run(opT, v_t, dang, DAMPING, 1e-6,
                                               1000), 3)
    print(f"pagerank R-MAT iteration loop warm ms "
          f"{' '.join(f'{t:.3f}' for t in loop)}", flush=True)
    # csr_spmv on the R-MAT P^T (long rows) against cuSPARSE; phase 28
    # prints its device times beside its bound
    PT = _transition_matrix(Wr)
    xr = torch.as_tensor(np.random.default_rng(SEED).uniform(0, 1, N_WEB),
                         dtype=torch.float32, device=v_t.device)
    rmat_fig = spmv_figures(torch, K, PT, PT.op(), xr,
                            f"n={N_WEB} R-MAT P^T", 200)
    del Wr, opT, v_t, dang

    seeds = np.random.default_rng(0).choice(N_WEB, N_PPR_SEEDS, replace=False)
    reset(K)
    rp = G.personalized_pagerank(W, seeds)
    counts = path_counts(K, launches)
    vp = np.zeros(N_WEB)
    vp[seeds] = 1.0 / N_PPR_SEEDS
    if counts != {"csr_spmv": 1 + 6 * (rp.iterations // 5)}:
        raise RuntimeError(f"personalized_pagerank: launches {counts}")
    print(f"personalized_pagerank ({N_PPR_SEEDS} seeds): "
          f"{check_pagerank(rp, vp, pagerank_oracle(W.csr, vp), 'ppr')}; "
          f"launches {counts}", flush=True)

    x0 = np.random.default_rng(1).uniform(-1, 1, N_WEB)
    reset(K)
    t0 = time.perf_counter()
    dg = G.degroot_consensus(W, x0, steps=DEGROOT_STEPS)
    dg_s = time.perf_counter() - t0
    counts = path_counts(K, launches)
    if counts != {"csr_spmv": DEGROOT_STEPS} or not np.all(
            np.isfinite(dg["opinions"])):
        raise RuntimeError(f"degroot_consensus: launches {counts}")
    print(f"degroot_consensus {DEGROOT_STEPS} steps: consensus "
          f"{dg['consensusValue']:.6f} spread {dg['spread']:.4f}, launches "
          f"{counts}, {dg_s * 1e3:.1f} ms (row_normalize and pack included)",
          flush=True)

    reset(K)
    t0 = time.perf_counter()
    fj = G.friedkin_johnsen(W, x0, susceptibility=FJ_SUSCEPTIBILITY)
    fj_s = time.perf_counter() - t0
    counts = path_counts(K, launches)
    Wn = G.social.row_normalize(W)
    x = np.asarray(fj["opinions"])
    sys_x = x - (1 - FJ_SUSCEPTIBILITY) * Wn.csr.matvec(x)
    rhs_fj = FJ_SUSCEPTIBILITY * x0
    rel = float(np.linalg.norm(sys_x - rhs_fj) / np.linalg.norm(rhs_fj))
    if not (fj["convergenceInfo"]["converged"] and rel < SOLVE_RTOL
            and counts.get("neumann_step")):
        raise RuntimeError(f"friedkin_johnsen: {fj['convergenceInfo']} host "
                           f"rel residual {rel} launches {counts}")
    print(f"friedkin_johnsen s={FJ_SUSCEPTIBILITY}: {fj['convergenceInfo']} "
          f"host f64 rel residual of I - (1-s) W {rel:.3e}, polarization "
          f"{fj['polarization']:.4f}, launches {counts}, {fj_s:.2f} s "
          f"(build and analysis included)", flush=True)

    reset(K)
    inf = G.influence_propagation(W, seeds.tolist())
    counts = path_counts(K, launches)
    scores = np.asarray(inf["influenceScores"])
    if not (inf["converged"] and np.allclose(scores, rp.scores, rtol=0,
                                             atol=1e-9)
            and counts.get("csr_spmv")):
        raise RuntimeError(f"influence_propagation: converged "
                           f"{inf['converged']} launches {counts}")
    print(f"influence_propagation: seed mass {inf['totalSeedInfluence']:.4f}"
          f", top {inf['topInfluenced'][0]}, launches {counts}", flush=True)
    return W, rmat_fig


def query_phase(torch, slt, K, A, b, r_main, launches, smi):
    """Phase 25: the queries on the headline matrix and the temporal lead at
    n=1000 (DIA route)."""
    from sublinear_tpu_torch import queries as Q
    from sublinear_tpu_torch.solvers import push as PUSH
    from sublinear_tpu_torch.solvers import random_walk as RW

    n = A.shape[0]
    phase(f"25 queries on the headline matrix n={n} ({smi})")
    x, x_err = r_main.solution, r_main.error_bounds.upper_bound
    t = np.random.default_rng(11).standard_normal(n)
    reset(K)
    out = Q.estimate_functional(A, b, t)
    counts = path_counts(K, launches)
    exact = float(t @ x)
    gap = abs(out["estimate"] - exact)
    allowed = 1e-3 * max(abs(exact), 1.0) + out["errorBound"]
    if not (gap <= allowed and counts.get("csr_spmv")):
        raise RuntimeError(f"estimate_functional: |{out['estimate']} - "
                           f"{exact}| = {gap} > {allowed}; launches {counts}")
    warm = warm_ms(torch, lambda: Q.estimate_functional(A, b, t), 3)
    print(f"estimate_functional: {out['estimate']:.6f} against t.x "
          f"{exact:.6f} (|diff| {gap:.3e} <= {allowed:.3e}), sweeps "
          f"{out['sweeps']}, residuals {out['forwardResidual']:.3e} / "
          f"{out['backwardResidual']:.3e}, launches {counts}; warm ms "
          f"{' '.join(f'{w:.2f}' for w in warm)}", flush=True)

    rows = [0, 1, n // 2, n - 1]
    cols = [0, 7, n // 3, n - 1]
    # estimate_entry's own options; each entry is one adjoint push or one
    # Neumann solve at them, which the entry's launches must equal
    entry_opts = slt.SolverOptions(epsilon=1e-4)
    for method in ("backward-push", "neumann"):
        worst, per_entry = 0.0, []
        unit = "Neumann solve" if method == "neumann" else "adjoint push"
        for row, col in zip(rows, cols):
            e = np.zeros(n)
            if method == "neumann":
                e[col] = 1.0
                ref = slt.solve(A, e, method="neumann", epsilon=1e-6)
                want, err = ref.solution[row], ref.error_bounds.upper_bound
                reset(K)
                slt.solve(A, e, entry_opts, method="neumann",
                          raise_on_fail=False)
            else:
                e[row] = 1.0
                want, err = x[row], x_err
                reset(K)
                PUSH.adjoint_solve(A, e, entry_opts)
            one = counted(K)
            reset(K)
            est = Q.estimate_entry(A, b, row, col, method=method)
            counts = path_counts(K, launches)
            if not (counts == one and counts.get("csr_spmv") and (
                    method != "neumann" or counts.get("neumann_step"))):
                raise RuntimeError(f"estimate_entry {method} ({row}, {col}): "
                                   f"launches {counts}, one {unit} {one}")
            gap = abs(est.estimate - want)
            if not gap <= est.confidence + err + 1e-7:
                raise RuntimeError(f"estimate_entry {method} ({row}, {col}): "
                                   f"{est.estimate} vs {want}, |diff| {gap} "
                                   f"> {est.confidence} + {err}")
            worst = max(worst, gap)
            per_entry.append(counts)
        warm = warm_ms(torch, lambda: Q.estimate_entry(A, b, rows[1], cols[1],
                                                       method=method), 3)
        print(f"estimate_entry {method} at rows {rows} (columns {cols}): "
              f"max |diff| from the 1e-6 solve {worst:.3e} (within each "
              f"estimate's half-width + the solve's bound), launches per "
              f"entry {per_entry} (each those of one {unit} at epsilon "
              f"1e-4); warm ms per entry "
              f"{' '.join(f'{w:.3f}' for w in warm)}", flush=True)

    sel = np.random.default_rng(11).integers(0, n, N_WALK_ROWS)
    opts = slt.SolverOptions(epsilon=1e-3, num_walks=WALKS)
    reset(K)
    est = Q.estimate_entries(A, b, sel, options=opts)
    counts = path_counts(K, launches)
    est2, var, steps = RW.walk_estimate(A, b, sel, opts)
    se = np.sqrt(np.maximum(var, 0.0) / WALKS)
    share = float(np.mean(np.abs(est - x[sel]) <= WALK_SE * se + 1e-6))
    if not (np.array_equal(est, est2) and share >= WALK_SHARE):
        raise RuntimeError(f"estimate_entries: {share:.4f} within {WALK_SE} "
                           f"SE; equal to walk_estimate "
                           f"{np.array_equal(est, est2)}")
    warm = warm_ms(torch, lambda: Q.estimate_entries(A, b, sel, options=opts),
                   3)
    print(f"estimate_entries (random walk, {N_WALK_ROWS} rows x {WALKS} "
          f"walks): {share:.4f} within {WALK_SE} SE of the exact solve, "
          f"{steps} steps, launches {counts}; warm ms "
          f"{' '.join(f'{w:.3f}' for w in warm)}, us per entry "
          f"{' '.join(f'{w / N_WALK_ROWS * 1e3:.3f}' for w in warm)}",
          flush=True)

    T = slt.Matrix(slt.generate("tridiagonal", 1000).csr.add_diagonal(2.0))
    if T._op_kind() != "dia":
        raise RuntimeError(f"the temporal system routes to {T._op_kind()!r}")
    b_t = slt.rhs(1000, seed=SEED)
    reset(K)
    pred = Q.predict_with_temporal_advantage(T, b_t)
    val = Q.validate_temporal_advantage(1000)
    counts = path_counts(K, launches)
    rel = host_residual(T, np.asarray(pred["solution"]), b_t)
    if not (pred["converged"] and val["converged"] and rel < SOLVE_RTOL
            and not counts):
        raise RuntimeError(f"temporal: {pred['converged']} {val} rel {rel} "
                           f"launches {counts}")
    shown = {k: v for k, v in pred.items() if k != "solution"}
    print(f"predict_with_temporal_advantage n=1000 (DIA): {shown}; host f64 "
          f"rel residual {rel:.3e}", flush=True)
    print(f"validate_temporal_advantage(1000): {val}", flush=True)


def f32_cg_witness(torch, slt, M, rhs):
    """The level an f32 CG reaches on M x = rhs, seen apart from the card:
    the host f64 relative residuals of the flows' own solve (CG, epsilon
    1e-8, 5000 iterations) run by the port on the CPU in f32 and in f64,
    and of the f64 answer rounded to f32 (the floor of any f32 answer).
    The f32 solve takes M's route ("csr"); the f64 one the ELL route, as
    the CSR operator is f32 only."""
    coo = M.csr.to_coo()
    out = {}
    for label, dtype, route in (("CPU f32", None, None),
                                ("CPU f64", torch.float64, "ell")):
        Mc = slt.Matrix.from_coo(*coo, M.shape, prefer=route, device="cpu")
        r = slt.solve(Mc, rhs, slt.SolverOptions(
            epsilon=1e-8, max_iterations=5000, dtype=dtype),
            method="conjugate-gradient", raise_on_fail=False)
        out[label] = host_residual(Mc, r.solution, rhs)
    out["f64 answer in f32"] = host_residual(
        Mc, r.solution.astype(np.float32).astype(np.float64), rhs)
    return out


def flow_phase(torch, slt, K, launches, smi):
    """Phase 26: resistance, flows, closeness, betweenness and communities
    on the connected undirected graph; returns its Laplacian and unit
    adjacency for phase 30."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import shortest_path

    from sublinear_tpu_torch import graph as G
    from sublinear_tpu_torch.graph import centrality as C

    n = N_UND
    phase(f"26 flows, resistance and centrality on the undirected graph "
          f"n={n} ({smi})")
    rng = np.random.default_rng(SEED)
    i = np.arange(n)
    u = np.r_[i, rng.integers(0, n, E_UND)]
    w = np.r_[(i + 1) % n, rng.integers(0, n, E_UND)]
    edges = list(zip(u.tolist(), w.tolist()))
    ones = np.ones(len(edges))
    t0 = time.perf_counter()
    L = G.weighted_laplacian(n, edges, ones)
    print(f"Laplacian: {len(edges)} edges, nnz {L.nnz}, route "
          f"{L._op_kind()}, built in {time.perf_counter() - t0:.2f} host s",
          flush=True)

    reset(K)
    er = G.effective_resistance(L, 0, n // 2)
    counts = path_counts(K, launches)
    Lg = G.grounded_laplacian(L)
    e = np.zeros(n - 1)
    e[0] = 1.0
    e[n // 2] = -1.0
    rel = host_residual(Lg, np.asarray(er["voltage"])[: n - 1], e)
    if not (rel < SOLVE_RTOL and counts.get("cg_step")
            and er["convergenceInfo"]["converged"]):
        raise RuntimeError(f"effective_resistance: {er['convergenceInfo']} "
                           f"host rel residual {rel} launches {counts}")
    warm = warm_ms(torch, lambda: G.effective_resistance(L, 0, n // 2), 2)
    print(f"effective_resistance(0, {n // 2}) = {er['effectiveResistance']:.6f}"
          f": {er['convergenceInfo']}, host f64 rel residual {rel:.3e}, "
          f"launches {counts}; warm ms {' '.join(f'{t:.1f}' for t in warm)}",
          flush=True)

    r_, c_, v_ = L.csr.to_coo()
    flows = (
        ("electrical_network", lambda: G.electrical_network(
            n, edges, ones, {0: 1.0, n - 1: 0.0}), "voltages",
         ([0, n - 1], 1e6), {0: 1e6}),
        ("min_cost_flow", lambda: G.min_cost_flow(
            n, edges, ones, {0: 1.0, n // 2: -1.0}), "potentials",
         ([0], 1.0), {0: 1.0, n // 2: -1.0}))
    for name, call, key, (diag_nodes, big), rhs_at in flows:
        reset(K)
        t0 = time.perf_counter()
        out = call()
        secs = time.perf_counter() - t0
        counts = path_counts(K, launches)
        M = slt.Matrix.from_coo(np.r_[r_, diag_nodes], np.r_[c_, diag_nodes],
                                np.r_[v_, np.full(len(diag_nodes), big)],
                                (n, n))
        rhs_f = np.zeros(n)
        for node, val in rhs_at.items():
            rhs_f[node] = val
        rel = host_residual(M, np.asarray(out[key]), rhs_f)
        info = out["convergenceInfo"]
        witness = f32_cg_witness(torch, slt, M, rhs_f)
        if not (rel < F32_CG_LEVEL and witness["CPU f32"] < F32_CG_LEVEL
                and counts.get("cg_step") and np.all(np.isfinite(out[key]))):
            raise RuntimeError(f"{name}: {info} host rel residual {rel} "
                               f"(the same CG on the CPU: {witness}) "
                               f"launches {counts}")
        print(f"{name}: {info} (epsilon 1e-8), host f64 rel residual "
              f"{rel:.3e} (< {F32_CG_LEVEL}), launches {counts}, {secs:.2f} "
              f"s with the Python loops over the edges; the same CG on the "
              f"CPU port, host f64 rel residuals: "
              f"{', '.join(f'{k} {v:.3e}' for k, v in witness.items())}",
              flush=True)

    Au = C._unit_graph(L)
    S = sp.csr_matrix((Au.csr.data, Au.csr.indices, Au.csr.indptr),
                      shape=Au.shape)
    nodes = np.arange(N_CLOSENESS)
    reset(K)
    close = np.asarray(G.closeness_centrality(L, nodes)["closenessVector"])
    path_counts(K, launches)
    t0 = time.perf_counter()
    levels = shortest_path(S, method="D", unweighted=True, indices=nodes)
    bfs_s = time.perf_counter() - t0
    for j in (0, N_CLOSENESS - 1):
        if not np.array_equal(levels[j], dijkstra(Au.csr, [nodes[j]])):
            raise RuntimeError(f"scipy BFS levels of source {j} differ from "
                               f"the dijkstra helper")
    reach = np.isfinite(levels)
    total = np.where(reach, levels, 0.0).sum(axis=1)
    cnt = reach.sum(axis=1) - 1.0
    want = np.where(total > 0, (cnt / (n - 1)) * (cnt / np.where(
        total > 0, total, 1.0)), 0.0)
    if not np.array_equal(close[nodes], want) or np.any(close[N_CLOSENESS:]):
        raise RuntimeError(f"closeness differs from the BFS levels: max "
                           f"{np.abs(close[nodes] - want).max()}")
    warm = warm_ms(torch, lambda: G.closeness_centrality(L, nodes), 2)
    print(f"closeness_centrality on {N_CLOSENESS} nodes: equal to the BFS "
          f"levels bit for bit (two rows held to the dijkstra helper; scipy "
          f"BFS {bfs_s:.2f} host s), max {close.max():.5f}; warm ms "
          f"{' '.join(f'{t:.1f}' for t in warm)}", flush=True)

    reset(K)
    bc = np.asarray(G.betweenness_centrality(
        L, num_samples=N_BC_CHECK, backend="device")["betweennessVector"])
    path_counts(K, launches)
    sources = np.random.default_rng(0).choice(n, N_BC_CHECK, replace=False)
    t0 = time.perf_counter()
    exact = C._betweenness_host(L, sources, n / N_BC_CHECK)
    host_s = time.perf_counter() - t0
    diff = np.abs(bc - exact)
    if not np.all(diff <= BC_RTOL * np.abs(exact)
                  + BC_RTOL * np.abs(exact).max()):
        raise RuntimeError(f"betweenness: max |device - host| "
                           f"{diff.max()} (max {np.abs(exact).max()})")
    print(f"betweenness_centrality {N_BC_CHECK} sources (device) against "
          f"_betweenness_host: max rel diff "
          f"{float(diff.max() / np.abs(exact).max()):.3e}, host oracle "
          f"{host_s:.2f} s", flush=True)
    t0 = time.perf_counter()
    g = C._unit_graph(L)
    C.in_edge_tables(g)
    C.in_edge_tables(g.transpose())
    torch.cuda.synchronize()
    tables_s = time.perf_counter() - t0
    for samples in (N_BC_CHECK, N_BC_TIMED):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        warm = warm_ms(torch, lambda: G.betweenness_centrality(
            L, num_samples=samples, backend="device"), 2)
        print(f"betweenness_centrality {samples} sources (device, one chunk)"
              f": warm ms {' '.join(f'{t:.1f}' for t in warm)} (each builds "
              f"the unit graph and its in- and out-edge tables on the host: "
              f"{tables_s:.2f} s alone); peak device bytes above the "
              f"{held} held before {torch.cuda.max_memory_allocated() - held}",
              flush=True)

    t0 = time.perf_counter()
    dc = G.detect_communities(Au)
    dc_s = time.perf_counter() - t0
    q = G.modularity(Au, np.asarray(dc["assignments"]))
    if not (q == dc["modularity"] and len(dc["assignments"]) == n):
        raise RuntimeError(f"detect_communities: {dc['quality']}")
    print(f"detect_communities (host): {dc['quality']}, modularity "
          f"{q:.3e}, {dc_s:.2f} host s", flush=True)
    return L, Au


def utility_phase(torch, slt, K, A, b, r_main, W, launches, smi):
    """Phase 27: the utilities reading the card."""
    import tempfile

    from sublinear_tpu_torch import graph as G
    from sublinear_tpu_torch.types import DeltaUpdate
    from sublinear_tpu_torch.utils import (
        ProfileLog, SolverCheckpoint, checkpoint_of, resume, update_rhs)
    from sublinear_tpu_torch.utils.memory_profiler import profile_memory
    from sublinear_tpu_torch.utils.profiling import memory_info

    phase(f"27 utilities ({smi})")
    log = ProfileLog()
    rec = log.add(A, r_main)
    if not (rec.backend == "cuda" and rec.chips == torch.cuda.device_count()
            and rec.iterations == r_main.iterations and log.records == [rec]):
        raise RuntimeError(f"record_solve: {rec}")
    print(f"record_solve on phase 4's solve: {rec.to_json()}", flush=True)
    info = memory_info()
    if not (info["devices"][0]["platform"] == "cuda"
            and info["devices"][0]["bytesInUse"] > 0):
        raise RuntimeError(f"memory_info: {info}")
    print(f"memory_info: {info}", flush=True)

    reset(K)
    with profile_memory("pagerank", n=W.shape[0], nnz=W.nnz) as prof:
        pr = G.pagerank(W)
    counts = path_counts(K, launches)
    if not (prof.backend == "cuda" and prof.device_peak_bytes > 0
            and pr.converged):
        raise RuntimeError(f"profile_memory: {prof}")
    print(f"profile_memory around PageRank n={W.shape[0]}: {prof.to_dict()}; "
          f"launches {counts}", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "ckpt.npz")
        checkpoint_of(r_main, b).save(path)
        ckpt = SolverCheckpoint.load(path)
    reset(K)
    res = resume(A, ckpt)
    counts = path_counts(K, launches)
    own = res.iterations - ckpt.iterations
    rel = host_residual(A, res.solution, b)
    if not (res.converged and own <= r_main.iterations and rel < SOLVE_RTOL):
        raise RuntimeError(f"resume: converged={res.converged} own "
                           f"iterations {own} host rel residual {rel}")
    print(f"resume from a saved checkpoint of phase 4's solve: {res.method}, "
          f"{own} more iterations (first solve {r_main.iterations}), host f64 "
          f"rel residual {rel:.3e}, launches {counts}", flush=True)
    rng = np.random.default_rng(3)
    delta = DeltaUpdate(indices=rng.choice(A.shape[0], N_DELTA, replace=False),
                        values=rng.uniform(-0.5, 0.5, N_DELTA))
    reset(K)
    r2, b_new = update_rhs(A, r_main, delta, b)
    counts = path_counts(K, launches)
    rel = host_residual(A, r2.solution, b_new)
    if not (r2.converged and rel < SOLVE_RTOL):
        raise RuntimeError(f"update_rhs: converged={r2.converged} rel {rel}")
    print(f"update_rhs with a {N_DELTA}-entry delta: {r2.method}, "
          f"{r2.iterations - r_main.iterations} more iterations, host f64 "
          f"rel residual to the new b {rel:.3e}, launches {counts}",
          flush=True)


# ------------------------------------------------------------ entry points

def entry_window(torch, K, launches, fn):
    """One call of an entry point in a launch-count window (counts set to 0
    right before it, read right after it and added to the kernels line's
    totals; nothing else in the window launches) under torch.profiler's
    device tracing alone: (result, counts, host ms of the window, device
    ms: the summed durations of every kernel and copy on the card in it,
    None if the profiler saw none).  The raw trace events are summed:
    key_averages() takes minutes over the ~10^6 events of the larger
    windows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    reset(K)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    counts = path_counts(K, launches)
    dev_ns = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA)
    return out, counts, host_ms, (dev_ns / 1e6 if dev_ns > 0 else None)


def bare_counts(K, fn):
    """(result, launch counts) of the bare library call ``fn``, counted
    the same way outside every entry point's window."""
    reset(K)
    out = fn()
    return out, counted(K)


def same_launches(label, counts, bare, host_ms, dev_ms):
    """Raise unless the entry point launched what the bare call launched;
    print both times."""
    if counts != bare:
        raise RuntimeError(f"{label}: launches {counts}, the bare call's "
                           f"{bare}: the entry point does device work of its "
                           f"own")
    idle = ("not measured" if dev_ms is None
            else f"{1 - dev_ms / host_ms:.4f}")
    print(f"  {label}: launches {counts} (= the bare call's); host ms "
          f"{host_ms:.1f}, device ms {fmt_ms(dev_ms)}, device idle share "
          f"{idle}", flush=True)


def equal_solution(label, x, want):
    x = np.asarray(x, dtype=np.float64)
    if not (x.shape == want.shape and np.array_equal(x, want)):
        raise RuntimeError(f"{label}: the solution after its JSON round trip "
                           f"differs from the library call's (max |diff| "
                           f"{np.abs(x - want).max()})")


def run_cli(cli, args):
    """(exit code, stdout, stderr) of one in-process CLI run."""
    import contextlib
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(args)
    return rc, out.getvalue(), err.getvalue()


class Scores:
    """A PageRank answer read from JSON, in check_pagerank's terms."""

    def __init__(self, doc):
        self.scores = np.asarray(doc["pageRankVector"])
        self.residual, self.converged = doc["residual"], doc["converged"]
        self.iterations = doc["iterations"]


def cli_phase(torch, slt, K, A, b, S, launches, smi):
    """Phase 29: the CLI in-process through cli.main and once as
    `python -m sublinear_tpu_torch.interfaces.cli`, on files in a
    temporary directory.  Returns the bare Neumann solve of the headline
    system, which phase 30 reuses."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        return cli_files(torch, slt, K, A, b, S, launches, smi, Path(tmp))


def cli_files(torch, slt, K, A, b, S, launches, smi, work):
    from sublinear_tpu_torch import queries as Q
    from sublinear_tpu_torch.formats.io import save_matrix
    from sublinear_tpu_torch.graph import pagerank
    from sublinear_tpu_torch.interfaces import cli

    n = A.shape[0]
    phase(f"29 the CLI on the headline matrix n={n} ({smi})")
    mtx, vec, spd = work / "A.mtx", work / "b.json", work / "S.json"
    t0 = time.perf_counter()
    save_matrix(A, str(mtx))
    vec.write_text(json.dumps(b.tolist()))
    save_matrix(S, str(spd))
    print(f"wrote {mtx.name} ({mtx.stat().st_size / 1e6:.1f} MB), "
          f"{spd.name} ({spd.stat().st_size / 1e6:.1f} MB), {vec.name} in "
          f"{time.perf_counter() - t0:.2f} host s", flush=True)

    solved = {}
    for method, path, M in (("neumann", mtx, A),
                            ("conjugate-gradient", spd, S)):
        out = work / f"x-{method}.json"
        (rc, _, _), counts, host_ms, dev_ms = entry_window(
            torch, K, launches, lambda: run_cli(cli, [
                "solve", "-m", str(path), "-b", str(vec), "--method", method,
                "-o", str(out)]))
        doc = json.loads(out.read_text())
        ref, bare = bare_counts(K, lambda: slt.solve(
            slt.Matrix(M.csr), b, method=method, epsilon=1e-6,
            max_iterations=1000))
        rel = host_residual(M, np.asarray(doc["solution"]), b)
        if not (rc == 0 and doc["converged"] and rel < SOLVE_RTOL):
            raise RuntimeError(f"cli solve {method}: rc {rc} {doc['method']} "
                               f"converged {doc['converged']} rel {rel}")
        equal_solution(f"cli solve {method}", doc["solution"], ref.solution)
        same_launches(f"solve --method {method} ({doc['method']}, "
                      f"{doc['iterations']} iterations, host f64 rel residual "
                      f"{rel:.3e}, bit-equal to solve()'s)", counts, bare,
                      host_ms, dev_ms)
        solved[method] = (out, ref)

    x_path, ref = solved["neumann"]
    (rc, out, _), counts, host_ms, dev_ms = entry_window(
        torch, K, launches, lambda: run_cli(cli, [
            "verify", "-m", str(mtx), "-b", str(vec), "-s", str(x_path)]))
    doc = json.loads(out)
    if not (rc == 0 and doc["verified"] and doc["relativeResidual"] < SOLVE_RTOL):
        raise RuntimeError(f"cli verify: rc {rc} {doc['relativeResidual']}")
    same_launches(f"verify (host f64 rel residual {doc['relativeResidual']:.3e}"
                  f", {len(doc['probes'])} probes)", counts, {}, host_ms, dev_ms)

    (rc, out, _), counts, host_ms, dev_ms = entry_window(
        torch, K, launches, lambda: run_cli(cli, ["analyze", "-m", str(mtx)]))
    want = slt.analyze(slt.Matrix(A.csr)).to_dict()
    if not (rc == 0 and json.loads(out) == want):
        raise RuntimeError(f"cli analyze: rc {rc}, differs from analyze()")
    same_launches(f"analyze (equal to analyze(): recommended "
                  f"{want['recommended_method']})", counts, {}, host_ms, dev_ms)

    row, col = n // 2, 7
    (rc, out, _), counts, host_ms, dev_ms = entry_window(
        torch, K, launches, lambda: run_cli(cli, [
            "estimate", "-m", str(mtx), "-b", str(vec), "--row", str(row),
            "--column", str(col), "--method", "neumann"]))
    est = json.loads(out)
    bare_est, bare = bare_counts(K, lambda: Q.estimate_entry(
        slt.Matrix(A.csr), b, row=row, column=col, method="neumann",
        epsilon=1e-3))
    e = np.zeros(n)
    e[col] = 1.0
    exact = slt.solve(A, e, method="neumann", epsilon=1e-6)
    gap = abs(est["estimate"] - exact.solution[row])
    if not (rc == 0 and est["estimate"] == bare_est.estimate
            and gap <= est["confidence"] + exact.error_bounds.upper_bound
            + 1e-7):
        raise RuntimeError(f"cli estimate: {est} vs bare {bare_est.estimate},"
                           f" exact {exact.solution[row]}")
    same_launches(f"estimate --method neumann ({row}, {col}): {est['estimate']:.6e}"
                  f", |diff| from the 1e-6 solve {gap:.3e} <= its half-width "
                  f"{est['confidence']:.3e} + the solve's bound", counts, bare,
                  host_ms, dev_ms)

    sizes = (1000, 10_000, N_MAIN)
    (rc, out, _), counts, host_ms, dev_ms = entry_window(
        torch, K, launches, lambda: run_cli(cli, [
            "benchmark", "--sizes", ",".join(map(str, sizes)), "--density",
            str(DENSITY_MAIN), "--method", "neumann"]))
    rows = json.loads(out)

    def ladder():
        for m in sizes:
            M = slt.generate("random-sparse", m, seed=SEED,
                             density=DENSITY_MAIN)
            for _ in range(2):
                slt.solve(M, slt.rhs(m, seed=SEED), method="neumann",
                          epsilon=1e-6, raise_on_fail=False)

    _, bare = bare_counts(K, ladder)
    if not (rc == 0 and [r["n"] for r in rows] == list(sizes)
            and all(r["converged"] for r in rows)):
        raise RuntimeError(f"cli benchmark: rc {rc} rows {rows}")
    same_launches("benchmark " + "; ".join(
        f"n={r['n']} {r['ms']:.2f} ms {r['iterations']} iterations"
        for r in rows), counts, bare, host_ms, dev_ms)

    Wd = digraph(slt, N_UND, E_DIGRAPH)
    gpath = work / "G.mtx"
    save_matrix(Wd, str(gpath))
    (rc, out, _), counts, host_ms, dev_ms = entry_window(
        torch, K, launches, lambda: run_cli(cli, ["pagerank", "-a", str(gpath)]))
    doc = json.loads(out)
    _, bare = bare_counts(K, lambda: pagerank(slt.Matrix(Wd.csr)))
    v = np.full(Wd.shape[0], 1.0 / Wd.shape[0])
    note = check_pagerank(Scores(doc), v, pagerank_oracle(Wd.csr, v),
                          "cli pagerank")
    if rc != 0:
        raise RuntimeError(f"cli pagerank: rc {rc}")
    same_launches(f"pagerank on a {Wd.shape[0]}-node digraph of {Wd.nnz} "
                  f"edges: {note}", counts, bare, host_ms, dev_ms)

    back, again = work / "G.json", work / "G2.mtx"
    (rcs, counts, host_ms, dev_ms) = entry_window(
        torch, K, launches, lambda: [run_cli(cli, ["convert", "-i", a, "-o", z])[0]
                                     for a, z in ((str(gpath), str(back)),
                                                  (str(back), str(again)))])
    if not (rcs == [0, 0] and again.read_bytes() == gpath.read_bytes()):
        raise RuntimeError(f"cli convert .mtx -> .json -> .mtx: rcs {rcs}, "
                           f"the files differ")
    same_launches(".mtx -> .json -> .mtx with convert: byte-identical",
                  counts, {}, host_ms, dev_ms)

    bad, two = work / "bad.json", work / "v2.json"
    bad.write_text(json.dumps({"rows": 2, "cols": 2, "data": [[1, 5], [5, 1]],
                               "format": "dense"}))
    two.write_text("[1.0, 1.0]")
    rc, out, err = run_cli(cli, ["solve", "-m", str(bad), "-b", str(two),
                                 "--method", "neumann"])
    code = json.loads(err.strip().splitlines()[-1])["code"]
    if not (rc == 2 and code == "E001" and out == ""):
        raise RuntimeError(f"cli non-DD neumann: rc {rc} code {code}")
    print(f"  a non-DD input with --method neumann exits {rc} with {code}",
          flush=True)

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "sublinear_tpu_torch.interfaces.cli", "solve",
         "-m", str(mtx), "-b", str(vec), "--method", "neumann"],
        capture_output=True, text=True, timeout=300, cwd=HERE)
    sub_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"python -m ...interfaces.cli solve: rc "
                           f"{proc.returncode}: {proc.stderr[-2000:]}")
    equal_solution("python -m ...interfaces.cli solve",
                   json.loads(proc.stdout)["solution"], ref.solution)
    print(f"  python -m sublinear_tpu_torch.interfaces.cli solve: rc 0, "
          f"bit-equal to solve()'s; {sub_s:.2f} host s with the process's "
          f"start (device ms not measured: another process)", flush=True)
    return ref


def mcp_phase(torch, slt, K, A, b, S, ref, graph, launches, smi):
    """Phase 30: the MCP server over stdio (serve-mcp in a subprocess) and
    in-process through MCPServer.handle_request."""
    from sublinear_tpu_torch import graph as G
    from sublinear_tpu_torch import queries as Q
    from sublinear_tpu_torch.interfaces import mcp_server
    from sublinear_tpu_torch.parallel.sharded import solve_batch
    from sublinear_tpu_torch.solvers.streaming import streaming_solve

    n = A.shape[0]
    phase(f"30 the MCP server at n={n} ({smi})")
    t0 = time.perf_counter()
    a_doc, b_list = A.to_dict(), b.tolist()
    solve_req = {"jsonrpc": "2.0", "id": 3, "method": "tools/call",
                 "params": {"name": "solve", "arguments": {
                     "matrix": a_doc, "vector": b_list, "method": "neumann"}}}
    line = json.dumps(solve_req)
    stdin = "\n".join([json.dumps({"jsonrpc": "2.0", "id": 1,
                                   "method": "initialize", "params": {}}),
                       json.dumps({"jsonrpc": "2.0", "id": 2,
                                   "method": "tools/list"}), line]) + "\n"
    print(f"request built in {time.perf_counter() - t0:.2f} host s: tools/call "
          f"solve is one line of {len(line) / 1e6:.1f} MB", flush=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "sublinear_tpu_torch.interfaces.cli",
         "serve-mcp"], input=stdin, capture_output=True, text=True,
        timeout=300, cwd=HERE)
    sub_s = time.perf_counter() - t0
    by_id = {d.get("id"): d for d in map(json.loads,
                                         proc.stdout.strip().splitlines())}
    out = json.loads(by_id[3]["result"]["content"][0]["text"])
    names = [t["name"] for t in by_id[2]["result"]["tools"]]
    if not (proc.returncode == 0 and names == [t["name"] for t in
                                               mcp_server.TOOLS]
            and by_id[1]["result"]["serverInfo"]["name"]
            == "sublinear-tpu-solver" and out["converged"]
            and out["metadata"]["backend"] == "cuda"):
        raise RuntimeError(f"serve-mcp over stdio: rc {proc.returncode} "
                           f"metadata {out.get('metadata')} "
                           f"{proc.stderr[-2000:]}")
    equal_solution("serve-mcp tools/call solve", out["solution"], ref.solution)
    print(f"  serve-mcp over stdio: initialize, tools/list ({len(names)} "
          f"tools), tools/call solve: backend {out['metadata']['backend']}, "
          f"{out['iterations']} iterations, bit-equal to solve()'s; "
          f"{sub_s:.2f} host s with the process's start (device ms not "
          f"measured: another process)", flush=True)

    srv = mcp_server.MCPServer()

    def call(name, args):
        resp = srv.handle_request({"jsonrpc": "2.0", "id": 9,
                                   "method": "tools/call",
                                   "params": {"name": name,
                                              "arguments": args}})
        if "error" in resp:
            raise RuntimeError(f"MCP {name}: {resp['error']['message']}")
        return json.loads(resp["result"]["content"][0]["text"])

    out, counts, host_ms, dev_ms = entry_window(
        torch, K, launches, lambda: call("solve", solve_req["params"]["arguments"]))
    _, bare = bare_counts(K, lambda: slt.solve(
        slt.Matrix(A.csr), b, method="neumann", epsilon=1e-6,
        raise_on_fail=False))
    equal_solution("MCP solve", out["solution"], ref.solution)
    if out["metadata"]["backend"] != "cuda":
        raise RuntimeError(f"MCP solve: {out['metadata']}")
    same_launches(f"solve (neumann, {out['iterations']} iterations, "
                  f"bit-equal to solve()'s)", counts, bare, host_ms, dev_ms)

    Bm = np.random.default_rng(0).standard_normal((n, N_RHS))
    opts = slt.SolverOptions(epsilon=1e-6, max_iterations=1000)
    for k in (N_RHS, N_RHS_CHAIN):
        Bk = Bm[:, :k]
        args = {"matrix": a_doc, "vectors": Bk.T.tolist()}
        out, counts, host_ms, dev_ms = entry_window(
            torch, K, launches, lambda: call("batchSolve", args))
        _, bare = bare_counts(K, lambda: solve_batch(slt.Matrix(A.csr), Bk,
                                                     opts))
        res = out["results"]
        X = np.stack([np.asarray(r["solution"]) for r in res], axis=1)
        rels = host_residuals(A, X, Bk)
        if not (len(res) == k and all(r["converged"] for r in res)
                and rels.max() < SOLVE_RTOL):
            raise RuntimeError(f"MCP batchSolve {k}: converged "
                               f"{sum(r['converged'] for r in res)} max rel "
                               f"{rels.max()}")
        same_launches(f"batchSolve {k} RHS ({res[0]['method']}, "
                      f"{res[0]['iterations']} iterations, max host f64 rel "
                      f"residual {rels.max():.3e})", counts, bare, host_ms,
                      dev_ms)
    del Bm, args

    s_doc = S.to_dict()
    args = {"matrix": s_doc, "vector": b_list, "method": "conjugate-gradient",
            "epsilon": 1e-6, "chunkIterations": 10}
    out, counts, host_ms, dev_ms = entry_window(
        torch, K, launches, lambda: call("sublinear_solver_stream", args))
    _, bare = bare_counts(K, lambda: list(streaming_solve(
        slt.Matrix(S.csr), b, slt.SolverOptions(epsilon=1e-6),
        method="conjugate-gradient", chunk_iters=10, include_solution=True)))
    if out["status"] != "completed":
        raise RuntimeError(f"MCP sublinear_solver_stream: {out['status']}")
    same_launches(f"sublinear_solver_stream (CG on the SPD form, "
                  f"{len(out['updates'])} updates, {out['iterations']} "
                  f"iterations)", counts, bare, host_ms, dev_ms)
    ver, counts, host_ms, dev_ms = entry_window(
        torch, K, launches, lambda: call("solver_verification", {
            "session_id": out["session_id"], "probe_count": 16,
            "tolerance": 1e-4}))
    if not ver["verified"]:
        raise RuntimeError(f"MCP solver_verification: {ver}")
    same_launches(f"solver_verification on its session (max error "
                  f"{ver['max_error']:.3e})", counts, {}, host_ms, dev_ms)

    L, Au = graph
    nu = Au.shape[0]
    out, counts, host_ms, dev_ms = entry_window(
        torch, K, launches, lambda: call("pageRank", {"adjacency": Au.to_dict()}))
    _, bare = bare_counts(K, lambda: G.pagerank(slt.Matrix(Au.csr)))
    v = np.full(nu, 1.0 / nu)
    note = check_pagerank(Scores(out), v, pagerank_oracle(Au.csr, v),
                          "MCP pageRank")
    same_launches(f"pageRank on phase 26's graph: {note}", counts, bare,
                  host_ms, dev_ms)

    target = nu // 2
    out, counts, host_ms, dev_ms = entry_window(
        torch, K, launches, lambda: call("effectiveResistance", {
            "laplacian": L.to_dict(), "source": 0, "target": target}))
    _, bare = bare_counts(K, lambda: G.effective_resistance(
        slt.Matrix(L.csr), 0, target))
    e = np.zeros(nu - 1)
    e[0], e[target] = 1.0, -1.0
    rel = host_residual(G.grounded_laplacian(L), np.asarray(out["voltage"])[:nu - 1], e)
    if not (out["convergenceInfo"]["converged"] and rel < SOLVE_RTOL):
        raise RuntimeError(f"MCP effectiveResistance: {out['convergenceInfo']}"
                           f" host rel residual {rel}")
    same_launches(f"effectiveResistance(0, {target}) = "
                  f"{out['effectiveResistance']:.6f}, host f64 rel residual "
                  f"{rel:.3e}", counts, bare, host_ms, dev_ms)

    row, col = n - 1, n // 3
    out, counts, host_ms, dev_ms = entry_window(
        torch, K, launches, lambda: call("estimateEntry", {
            "matrix": a_doc, "vector": b_list, "row": row, "column": col,
            "method": "neumann"}))
    bare_est, bare = bare_counts(K, lambda: Q.estimate_entry(
        slt.Matrix(A.csr), b, row=row, column=col, method="neumann",
        epsilon=1e-3, confidence=0.95))
    e = np.zeros(n)
    e[col] = 1.0
    exact = slt.solve(A, e, method="neumann", epsilon=1e-6)
    gap = abs(out["estimate"] - exact.solution[row])
    if not (out["estimate"] == bare_est.estimate and gap <= out["confidence"]
            + exact.error_bounds.upper_bound + 1e-7):
        raise RuntimeError(f"MCP estimateEntry: {out} vs exact "
                           f"{exact.solution[row]}")
    same_launches(f"estimateEntry neumann ({row}, {col}): |diff| from the "
                  f"1e-6 solve {gap:.3e}", counts, bare, host_ms, dev_ms)


def http_phase(torch, slt, K, S, b, launches, smi):
    """Phase 31: the HTTP server in a thread: /health, a CG job's chunk
    stream, solve + update_rhs on the WebSocket, a swarm node and a job
    routed to it."""
    import threading
    import urllib.request

    from sublinear_tpu_torch.interfaces import http_server
    from sublinear_tpu_torch.solvers.streaming import (StreamControl,
                                                       streaming_solve)

    n = S.shape[0]
    phase(f"31 the HTTP server and its WebSocket ({smi})")
    server = http_server.make_server("127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/health", timeout=60) as resp:
            health = json.loads(resp.read())
        if not (health["backend"] == "cuda"
                and health["devices"] == torch.cuda.device_count() == 1):
            raise RuntimeError(f"/health: {health}")
        print(f"  /health: {health}", flush=True)

        payload = {"matrix": S.to_dict(), "vector": b.tolist(),
                   "method": "conjugate-gradient", "epsilon": 1e-6,
                   "verifyEvery": 4}
        body = json.dumps(payload).encode()

        def stream():
            req = urllib.request.Request(
                url + "/api/v1/solve-stream", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as resp:
                return [json.loads(x) for x in resp.read().splitlines()]

        lines, counts, host_ms, dev_ms = entry_window(torch, K, launches,
                                                      stream)
        _, bare = bare_counts(K, lambda: list(streaming_solve(
            slt.Matrix(S.csr), b, slt.SolverOptions(epsilon=1e-6,
                                                    max_iterations=1000),
            method="conjugate-gradient", chunk_iters=10,
            control=StreamControl(), verify_every=4, verify_probes=16,
            verify_tolerance=1e-4)))
        chunks, done = lines[:-1], lines[-1]
        checks = [c["verification"] for c in chunks if "verification" in c]
        rel = host_residual(S, np.asarray(chunks[-1]["solution"]), b)
        if not (done["status"] == "completed" and chunks[-1]["converged"]
                and checks and all(c["verified"] for c in checks)
                and rel < SOLVE_RTOL):
            raise RuntimeError(f"solve-stream: {done} verification {checks} "
                               f"rel {rel}")
        same_launches(f"POST /api/v1/solve-stream CG at n={n} ({len(body) / 1e6:.1f}"
                      f" MB): {len(chunks)} chunks to completed, "
                      f"{len(checks)} verification events passed, host f64 "
                      f"rel residual {rel:.3e}", counts, bare, host_ms, dev_ms)

        ws_case(torch, slt, K, url, launches)
        swarm_case(torch, slt, K, url, http_server.SWARM, launches)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def ws_case(torch, slt, K, url, launches):
    """solve then update_rhs on /ws: the final solution is held to the RHS
    of its rhsVersion, whichever that is, and the window's launches to a
    streaming_solve that applies the delta where the session did."""
    from sublinear_tpu_torch.interfaces.websocket import connect
    from sublinear_tpu_torch.solvers.streaming import (StreamControl,
                                                       streaming_solve)

    A0 = slt.generate("random-sparse", N_WS, seed=SEED, density=DENSITY_WS)
    r, c, v = A0.csr.to_coo()
    M = symmetric_dd(slt, r, c, v, N_WS)
    b = slt.rhs(N_WS, seed=SEED)
    delta = {"indices": [1, 2], "values": [3.0, -2.0]}
    msg = {"type": "solve", "matrix": M.to_dict(), "vector": b.tolist(),
           "method": "conjugate-gradient", "epsilon": 1e-6,
           "chunkIterations": 1, "verifyEvery": 2, "verifyTolerance": 1e-4}

    def session():
        ws, sock = connect(url.replace("http", "ws") + "/ws", timeout=60)
        try:
            if ws.read_message() is None:
                raise RuntimeError("/ws closed before its welcome")
            ws.send_json(msg)
            updates, answers, sent = [], [], False
            while True:
                got = ws.read_message()
                if got is None:
                    raise RuntimeError("/ws closed mid-session")
                doc = json.loads(got[1].decode())
                if doc["type"] in ("rhs_updated", "error"):
                    answers.append(doc)
                elif doc["type"] == "session_complete":
                    break
                elif doc["type"] == "session_update":
                    updates.append(doc)
                    if not sent:
                        ws.send_json({"type": "update_rhs",
                                      "session_id": doc["session_id"],
                                      "delta": delta})
                        sent = True
            if not answers:
                answers.append(json.loads(ws.read_message()[1].decode()))
            return doc, updates, answers
        finally:
            ws.close()
            sock.close()

    (done, updates, answers), counts, host_ms, dev_ms = entry_window(
        torch, K, launches, session)
    versions = [u.get("rhsVersion", 0) for u in updates]
    at = versions.index(1) if 1 in versions else None  # chunks before it
    b_new = b.copy()
    b_new[delta["indices"]] += delta["values"]

    def replay():
        ctrl = StreamControl()
        for i, _ in enumerate(streaming_solve(
                slt.Matrix(M.csr), b, slt.SolverOptions(epsilon=1e-6,
                                                        max_iterations=1000),
                method="conjugate-gradient", chunk_iters=1, control=ctrl,
                verify_every=2, verify_probes=16, verify_tolerance=1e-4), 1):
            if i == at:
                ctrl.push_delta(delta["indices"], delta["values"])

    _, bare = bare_counts(K, replay)
    last, (answer,) = updates[-1], answers
    want_b = b_new if versions[-1] == 1 else b
    rel = host_residual(M, np.asarray(last["solution"]), want_b)
    if not (done["status"] == "completed" and last["converged"]
            and rel < SOLVE_RTOL and (answer["type"] == "rhs_updated"
                                      or versions[-1] == 0)):
        raise RuntimeError(f"/ws solve + update_rhs: {done} answer {answer} "
                           f"versions {versions} rel {rel}")
    same_launches(f"/ws solve + update_rhs (CG, SPD n={N_WS}): answer "
                  f"{answer['type']}, {len(updates)} updates, rhsVersion "
                  f"{versions[-1]} (from update {at}), host f64 rel residual "
                  f"to that RHS {rel:.3e}", counts, bare, host_ms, dev_ms)


def swarm_case(torch, slt, K, url, swarm, launches):
    """A SwarmNode joins over /ws/swarm; a solve job routed to it runs on
    the card, and the node verifies its session on request."""
    import urllib.request

    from sublinear_tpu_torch.interfaces.swarm import SwarmNode

    node = SwarmNode(url.replace("http", "ws") + "/ws/swarm",
                     node_id="card-node", heartbeat_interval=5)
    node.connect()
    try:
        M = slt.generate("random-sparse", N_WS, seed=SEED, density=5e-4)
        b = slt.rhs(N_WS, seed=SEED)
        body = json.dumps({"matrix": M.to_dict(), "vector": b.tolist(),
                           "method": "neumann"}).encode()

        def post(path, data):
            req = urllib.request.Request(url + path, data=data, headers={
                "Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as resp:
                return json.loads(resp.read())

        out, counts, host_ms, dev_ms = entry_window(
            torch, K, launches, lambda: post("/api/v1/swarm/solve", body))
        ref, bare = bare_counts(K, lambda: slt.solve(
            slt.Matrix(M.csr), b, method="neumann", epsilon=1e-6,
            raise_on_fail=False))
        if not (out["workerId"] == "card-node" and out["converged"]):
            raise RuntimeError(f"swarm solve: worker {out['workerId']} "
                               f"converged {out['converged']}")
        equal_solution("swarm solve", out["solution"], ref.solution)
        node.add_session("card", M, b, np.asarray(out["solution"]))
        ver = post("/api/v1/swarm/verify", json.dumps({
            "nodeId": "card-node", "sessionId": "card", "probeCount": 16,
            "timeout": 60, "tolerance": 1e-4}).encode())
        if not (ver["verified"] and ver["node_id"] == "card-node"):
            raise RuntimeError(f"swarm verify: {ver}")
        same_launches(f"/ws/swarm node joined; POST /api/v1/swarm/solve routed"
                      f" to it (neumann n={N_WS}, bit-equal to solve()'s); its "
                      f"verification max error {ver['max_error']:.3e}", counts,
                      bare, host_ms, dev_ms)
    finally:
        node.disconnect()


def bench_phase(torch, slt, K, launches, smi):
    """Phase 32: benchmarks.py on the card."""
    from sublinear_tpu_torch import benchmarks as BM
    from sublinear_tpu_torch.generate import CATALOG_KINDS, catalog_matrix
    from sublinear_tpu_torch.parallel.sharded import solve_batch

    phase(f"32 benchmarks.py ({smi})")
    rows, counts, host_ms, dev_ms = entry_window(
        torch, K, launches, BM.bench_solve_scaling_reference_sizes)

    def ladder():
        for m, density in ((1000, 0.001), (10_000, 0.001), (N_MAIN, 1e-4)):
            M = slt.generate("random-sparse", m, seed=SEED, density=density)
            for _ in range(4):
                slt.solve(M, slt.rhs(m, seed=SEED), method="neumann",
                          epsilon=1e-6, raise_on_fail=False)

    _, bare = bare_counts(K, ladder)
    if not all(r.converged for r in rows):
        raise RuntimeError(f"bench_solve_scaling_reference_sizes: {rows}")
    same_launches("bench_solve_scaling_reference_sizes " + "; ".join(
        f"n={r.n} {r.wall_ms:.3f} ms {r.iterations} iterations" for r in rows),
        counts, bare, host_ms, dev_ms)

    r, counts, host_ms, dev_ms = entry_window(torch, K, launches, BM.bench_spmv)
    M = slt.generate("random-sparse", r.n, seed=11, density=100 / r.n)
    M._prefer = "ell"
    x = M.pad_vector(slt.rhs(r.n, seed=11))
    _, bare = bare_counts(K, lambda: M.op().matvec(x))
    b_ms = 12 * r.nnz / HBM_BYTES_PER_S * 1e3
    same_launches(f"bench_spmv n={r.n} ({r.nnz} nnz, ELL {r.extra['slotCount']}"
                  f" slots, tail {r.extra['tailNnz']}): {r.wall_ms:.5f} ms per "
                  f"product (CUDA events), {r.extra['nnzPerSecond'] / 1e9:.2f} "
                  f"Gnnz/s, {r.extra['approxBandwidthGBs']:.1f} GB/s at 12 "
                  f"B/nnz; the 12 B/nnz bound at 3.35 TB/s {b_ms:.5f} ms, "
                  f"{b_ms / r.wall_ms:.3f} of it", counts, bare, host_ms,
                  dev_ms)

    r, counts, host_ms, dev_ms = entry_window(
        torch, K, launches, lambda: BM.bench_batch_solve(n=N_MAIN, nrhs=N_RHS))
    T = slt.Matrix(slt.generate("tridiagonal", N_MAIN).csr.add_diagonal(0.5))
    Bt = np.random.default_rng(9).normal(size=(N_MAIN, N_RHS))
    _, bare = bare_counts(K, lambda: [solve_batch(
        T, Bt, slt.SolverOptions(epsilon=1e-6)) for _ in range(4)])
    if not r.converged:
        raise RuntimeError(f"bench_batch_solve: {r}")
    same_launches(f"bench_batch_solve n={N_MAIN} x {N_RHS} RHS (tridiagonal "
                  f"+ 0.5 I, DIA route): {r.wall_ms:.2f} ms per batch, "
                  f"{r.iterations} iterations, max residual {r.residual:.3e}",
                  counts, bare, host_ms, dev_ms)

    acc, counts, host_ms, dev_ms = entry_window(
        torch, K, launches, lambda: BM.accuracy_validation(sizes=(50, 100, 200)))
    bad = [a for a in acc if "error" in a
           and a["error"] != "NotDiagonallyDominantError"]
    if bad:
        raise RuntimeError(f"accuracy_validation: rows failed with errors "
                           f"other than NotDiagonallyDominantError: {bad}")

    def catalog_solves():
        for kind in CATALOG_KINDS:
            M = catalog_matrix(kind, 200, seed=0)
            for method in ("neumann", "conjugate-gradient", "jacobi",
                           "bicgstab"):
                try:
                    slt.solve(M, slt.rhs(200, seed=0), slt.SolverOptions(
                        epsilon=1e-6), method=method, raise_on_fail=False)
                except slt.NotDiagonallyDominantError:
                    pass

    _, bare = bare_counts(K, catalog_solves)
    applicable = [a for a in acc if not a.get("skipped")]
    n_pass = sum(a["passed"] for a in applicable)
    same_launches(f"accuracy_validation(sizes=(50, 100, 200)): {n_pass} of "
                  f"{len(applicable)} applicable rows passed, "
                  f"{len(acc) - len(applicable)} skipped (E001), "
                  f"{len(applicable) - n_pass} failed the 1.5e-6 contract "
                  f"without error (bare: one solve per kind and method at "
                  f"n=200)", counts, bare, host_ms, dev_ms)

    rep, counts, host_ms, dev_ms = entry_window(
        torch, K, launches, lambda: BM.dashboard(full=False))
    if not (rep["backend"] == "cuda" and rep["deviceCount"] == 1):
        raise RuntimeError(f"dashboard: backend {rep['backend']} "
                           f"deviceCount {rep['deviceCount']}")
    a = rep["accuracy"]
    same_launches(f"dashboard(full=False): backend {rep['backend']}, "
                  f"accuracy {a['passed']}/{a['total']}, "
                  f"{len(rep['timing'])} timing rows, fitted exponent "
                  f"{rep['complexity']['fit']['exponent']:.3f} (every matrix "
                  f"of n <= 1000: the dense and DIA routes and the walkers)",
                  counts, {}, host_ms, dev_ms)


# ----------------------------------------------------------------- models

def stage_line(rep, stage):
    q = rep[stage]
    return (f"{stage} p50 {q['p50']:.4f} p99 {q['p99']:.4f} p99.9 "
            f"{q['p999']:.4f}")


def series(n):
    """The CLI's built-in synthetic series at t = arange(n)."""
    t = np.arange(n, dtype=np.float32)
    return np.sin(2 * np.pi * t / 50) + 0.1 * np.sin(2 * np.pi * t / 7)


def tick_launches(torch, pred, window, ticks=10):
    """(kernels, copies) on the card per streaming tick: a CUDA-only
    torch.profiler window over ``ticks`` warm ticks."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(SEED)
    pred.init_stream(rng.standard_normal((window, 1)).astype(np.float32))
    xs = rng.standard_normal((ticks + 3, 1)).astype(np.float32)
    for x in xs[:3]:
        pred.predict_tick(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for x in xs[3:]:
            pred.predict_tick(x)
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    copies = sum(n.startswith(("Memcpy", "Memset")) for n in names)
    return (len(names) - copies) / ticks, copies / ticks


def models_phase(torch, slt, K, launches, smi):
    """Phase 33: the temporal models at the shipped configs' width (window
    256, hidden 32): nn-latency and train through cli.main, train_system_b
    over 8192 windows with its select_samples window counted, and the
    streaming ticks held to the full forwards."""
    from sublinear_tpu_torch import models as M
    from sublinear_tpu_torch.graph import pagerank
    from sublinear_tpu_torch.interfaces import cli
    from sublinear_tpu_torch.models import pagerank_selector, trainer
    from sublinear_tpu_torch.models.config import SHIPPED
    from sublinear_tpu_torch.ops import dense_fused as DF

    t_phase = time.perf_counter()
    phase(f"33 the temporal models at window 256, hidden 32 ({smi})")
    cfg_a, cfg_b = (M.Config.load(SHIPPED[n])
                    for n in ("A_traditional", "B_temporal_solver"))
    window = cfg_a.common.window_steps
    if not (window == cfg_b.common.window_steps == 256
            and cfg_a.model.hidden_size == cfg_b.model.hidden_size == 32):
        raise RuntimeError("the shipped configs' width changed")

    # (a) nn-latency through the CLI, 1000 ticks each
    for name, label in (("A_traditional", "System A (GRU, int8)"),
                        ("B_temporal_solver", "System B")):
        reset(K, DF)
        t0 = time.perf_counter()
        rc, out, err = run_cli(cli, ["nn-latency", "--config", SHIPPED[name],
                                     "--ticks", str(N_TICKS)])
        wall = time.perf_counter() - t0
        counts = {**counted(K), **{k: v for k, v in DF.LAUNCHES.items() if v}}
        rep = json.loads(out.strip().splitlines()[-1])
        if rc != 0 or counts or rep["ticks"] != N_TICKS or "tick" not in rep:
            raise RuntimeError(f"nn-latency {name}: rc {rc}, launches of the "
                               f"port's kernels {counts}, {err[-500:]}")
        print(f"  nn-latency {label}, {N_TICKS} ticks ({wall:.1f} s; no launch "
              f"of the port's kernels): staged ms " + "; ".join(
                  stage_line(rep, st) for st in
                  ("ingest", "prior", "network", "gate", "actuation",
                   "total")) + f"; streaming {stage_line(rep, 'tick')}; "
              f"meets_targets {rep['meets_targets']} (P99.9 <= "
              f"{rep['budget_ms']['total_p999']} ms)", flush=True)
        # the same predictor eager (graphs off) in this call, and the
        # kernels each tick runs on the card in either form
        if name == "A_traditional":
            model = M.build_system(cfg_a)
            t = M.Trainer(model, window=window, training_config=cfg_a.training)

            def make(graphs):
                return M.Predictor.new_system_a(model, t.state.params,
                                                cfg_a.inference, quantize=True,
                                                graphs=graphs)
        else:
            sysb = M.build_system(cfg_b)

            def make(graphs):
                return M.Predictor.new_system_b(sysb, cfg_b.inference,
                                                graphs=graphs)
        eager = make(False)
        rng = np.random.default_rng(SEED)
        for _ in range(3):
            eager.predict(rng.standard_normal((window, 1)).astype(np.float32))
        eager.stats.reset()
        for _ in range(N_EAGER_STAGED):
            eager.predict(rng.standard_normal((window, 1)).astype(np.float32))
        staged = eager.stats.report()
        eager.init_stream(rng.standard_normal((window, 1)).astype(np.float32))
        for _ in range(25):
            eager.predict_tick(rng.standard_normal(1).astype(np.float32))
        eager.tick_ms.clear()
        for _ in range(N_TICKS):
            eager.predict_tick(rng.standard_normal(1).astype(np.float32))
        tick = eager.tick_percentiles()
        print(f"  {label} eager (graphs off), same call: staged ms over "
              f"{N_EAGER_STAGED} predicts " + "; ".join(
                  stage_line(staged, st) for st in ("prior", "network", "gate",
                                                    "total"))
              + f"; streaming tick over {N_TICKS} p50 {tick['p50']:.4f} p99 "
              f"{tick['p99']:.4f} p99.9 {tick['p999']:.4f}", flush=True)
        for pred in (eager, make(None)):
            kern, copies = tick_launches(torch, pred, window)
            print(f"  {label} streaming tick ({'CUDA graph' if pred.graphs else 'eager'}"
                  f"): {kern:.1f} kernels and {copies:.1f} copies on the card "
                  f"per tick (torch.profiler, 10 ticks)", flush=True)

    # (b) train through the CLI: the A config on the built-in series
    steps = []
    step = trainer.Trainer._train_step

    def timed_step(self, w, y):
        t0 = time.perf_counter()
        out = step(self, w, y)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
        return out

    trainer.Trainer._train_step = timed_step
    try:
        reset(K, DF)
        t0 = time.perf_counter()
        rc, out, err = run_cli(cli, ["train", "--config", SHIPPED["A_traditional"],
                                     "--verbose"])
        wall = time.perf_counter() - t0
    finally:
        trainer.Trainer._train_step = step
    lines = out.strip().splitlines()
    doc = json.loads(lines[-1])
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in lines[:-1]
              if ln.startswith("epoch ")]
    counts = {**counted(K), **{k: v for k, v in DF.LAUNCHES.items() if v}}
    if not (rc == 0 and not counts and len(losses) == doc["epochs_run"]
            and losses[-1] < losses[0] and np.isfinite(doc["val_loss"])):
        raise RuntimeError(f"train: rc {rc}, {doc}, losses {losses}, "
                           f"launches {counts}")
    st = np.asarray(steps[3:])
    print(f"  train --config A_traditional.json (built-in series, window "
          f"{window}, batch {cfg_a.training.batch_size}; each step one CUDA "
          f"graph replay): epochs_run {doc['epochs_run']}, loss "
          f"{losses[0]:.6g} -> {losses[-1]:.6g}, val_loss "
          f"{doc['val_loss']:.6g}; {len(steps)} train steps, ms per step "
          f"(host, synchronized) median {np.median(st):.2f} p90 "
          f"{np.percentile(st, 90):.2f}; {wall:.1f} s in all", flush=True)
    # the eager step (graphs off) in this call, on the same batch shape
    Wa, Ya = M.make_windows(series(4096), window=window)
    tr = M.Trainer(M.build_system(cfg_a), window=window,
                   training_config=cfg_a.training, graphs=False)
    bw, by = (torch.as_tensor(a[:cfg_a.training.batch_size], device=tr.device)
              for a in (Wa, Ya))
    eager_ms = []
    for _ in range(N_EAGER_STEPS):
        t0 = time.perf_counter()
        float(tr._train_step(bw, by))
        eager_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"  the same train step eager (graphs off): ms per step median "
          f"{np.median(eager_ms[2:]):.2f} over {N_EAGER_STEPS - 2} warm steps",
          flush=True)

    # (c) train_system_b over 8192 windows, the selection window counted
    s = series(N_SYS_B + window + N_SYS_B_VAL)
    W, Y = M.make_windows(s, window=window)
    Wt, Yt = W[:N_SYS_B], Y[:N_SYS_B]
    Wv, Yv = W[N_SYS_B:N_SYS_B + N_SYS_B_VAL], Y[N_SYS_B:N_SYS_B + N_SYS_B_VAL]
    sysb = M.build_system(cfg_b)
    select = pagerank_selector.select_samples
    window_counts, sel = {}, {}

    def counted_select(*a, **kw):
        torch.cuda.synchronize()
        reset(K, DF)
        t0 = time.perf_counter()
        out = select(*a, **kw)
        torch.cuda.synchronize()
        sel["ms"] = (time.perf_counter() - t0) * 1e3
        window_counts.update(path_counts(K, launches))
        window_counts.update({k: v for k, v in DF.LAUNCHES.items() if v})
        sel["out"] = out
        return out

    pagerank_selector.select_samples = counted_select
    try:
        t0 = time.perf_counter()
        hist = M.train_system_b(sysb, Wt, Yt, cfg_b, validation_data=(Wv, Yv))
        fit_s = time.perf_counter() - t0
    finally:
        pagerank_selector.select_samples = select
    feats = Wt.reshape(N_SYS_B, -1)
    g = M.similarity_graph(feats, k=cfg_b.system.active_selection.k)
    reset(K, DF)
    r = pagerank(g, damping=DAMPING, epsilon=1e-8)
    bare = {**counted(K), **{k: v for k, v in DF.LAUNCHES.items() if v}}
    if g._op_kind() != "csr":
        raise RuntimeError(f"the selection graph takes {g._op_kind()}")
    if not (window_counts == bare and set(bare) == {"csr_spmv"}):
        raise RuntimeError(f"select_samples launched {window_counts}, the bare "
                           f"pagerank on its graph {bare}")
    if not np.array_equal(np.asarray(sel["out"]["allScores"]), r.scores):
        raise RuntimeError("select_samples' scores differ from the bare "
                           "pagerank's on the same graph")
    v = np.full(N_SYS_B, 1.0 / N_SYS_B)
    check = check_pagerank(r, v, pagerank_oracle(g.csr, v), "selection")
    samples = [h["samples"] for h in hist]
    want = [N_SYS_B] * 2 + [cfg_b.system.active_selection.samples_per_epoch] * (
        len(hist) - 2)
    if samples != want or not hist[-1]["loss"] < hist[0]["loss"]:
        raise RuntimeError(f"train_system_b: samples {samples}, losses "
                           f"{[h['loss'] for h in hist]}")
    # held-out error: the gated model against the Kalman prior alone
    with torch.no_grad():
        wv = torch.as_tensor(Wv, device=sysb.kalman.device)
        sT, _ = sysb.kalman.filter_sequence(wv[:, :, :1])
        prior = sysb.kalman.forecast(sT, 1).reshape(-1, 1)
        raw = (prior + sysb.net(wv.reshape(len(Wv), -1), prior)).cpu().numpy()
    prior = prior.cpu().numpy()
    _, passed = sysb.gate.verify(np.concatenate([raw, np.zeros_like(raw)], 1))
    gated = np.where(passed[:, None], raw, prior)
    err_model = float(np.mean((Yv - gated) ** 2))
    err_prior = float(np.mean((Yv - prior) ** 2))
    if not err_model < err_prior:
        raise RuntimeError(f"System B held-out error {err_model} does not beat "
                           f"the prior's {err_prior}")
    print(f"  train_system_b over {N_SYS_B} windows ({N_SYS_B_VAL} held out), "
          f"{fit_s:.1f} s: graph {g.nnz} entries (route {g._op_kind()}), "
          f"select_samples {sel['ms']:.1f} ms launching {window_counts} (= the "
          f"bare pagerank's), pagerank {check}, converged {r.converged}; "
          f"samples per epoch {samples}; gate_pass_rate "
          f"{[h['gate_pass_rate'] for h in hist]}; loss "
          + " ".join(f"{h['loss']:.4g}" for h in hist) + "; val_loss "
          + " ".join(f"{h['val_loss']:.4g}" for h in hist)
          + f"; held-out mse model {err_model:.6g} vs prior alone "
          f"{err_prior:.6g} (gate passed {int(passed.sum())} of "
          f"{len(passed)})", flush=True)

    # (d) streaming ticks against the full forwards, int8 against f32
    rng = np.random.default_rng(SEED)
    w = rng.standard_normal((window, 1)).astype(np.float32)
    xs = rng.standard_normal((N_PARITY_TICKS, 1)).astype(np.float32)
    for arch in ("gru", "tcn"):
        model = M.SystemA(hidden=32, arch=arch, seed=SEED)
        pred = M.Predictor.new_system_a(model)
        pred.init_stream(w)
        hist_w = w
        for x in xs:
            out = pred.predict_tick(x)
            hist_w = (np.concatenate([hist_w, x[None]]) if arch == "gru"
                      else np.concatenate([hist_w[1:], x[None]]))
        with torch.no_grad():
            full = model(torch.as_tensor(
                hist_w, device=model.head0.weight.device)).cpu().numpy()
        err = float(np.max(np.abs(out - full) / np.maximum(np.abs(full), 1e-30)))
        if not np.allclose(out, full, rtol=1e-5, atol=1e-6):
            raise RuntimeError(f"{arch} tick {out} != full forward {full}")
        quant = M.Predictor.new_system_a(model, quantize=True)
        full_pred = M.Predictor.new_system_a(model)
        q_err = max(float(np.max(np.abs(quant.predict(wi).value
                                        - full_pred.predict(wi).value)))
                    for wi in (w, hist_w[-window:]))
        if not q_err <= 0.05:
            raise RuntimeError(f"{arch} int8 output {q_err} from the f32 one")
        print(f"  {arch} System A: tick {N_PARITY_TICKS} after init_stream = "
              f"the {'full-history' if arch == 'gru' else 'full-window'} "
              f"forward (max rel diff {err:.2e}, rtol 1e-5); int8 - f32 max "
              f"|diff| {q_err:.4f} (bound 0.05)", flush=True)
    print(f"  phase 33: {time.perf_counter() - t_phase:.1f} s", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", type=Path, default=None,
                    help="profile one warm n=100k solve into this directory")
    args = ap.parse_args()
    t_script = time.perf_counter()

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
    from sublinear_tpu_torch import native

    t0 = time.perf_counter()
    print(f"native host helpers (g++): built={native.available()} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
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
    # the figures phase 28 prints, by kernel, the first of each on the path
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
    r_main, rel = check_solve(slt, A, b, f"n={N_MAIN}")
    launches = dict(K.LAUNCHES)
    if not (launches["csr_spmv"] and launches["neumann_step"]):
        raise RuntimeError(f"a kernel of the main path never launched: "
                           f"{launches}")
    print(f"iterations={r_main.iterations} residual={r_main.residual:.3e} "
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
    cases = [(name, n, B, DENSE_ITERS)
             for name in ("dense_neumann_fused", "dense_jacobi_fused",
                          "dense_power_fused")
             for n in DENSE_SIZES + (N_DENSE_GLOBAL,) for B in (1, 4)]
    cases += [("dense_neumann_fused_bf16x3", 1536, B, DENSE_ITERS)
              for B in (1, 4)]
    # iters=0: Neumann x0 + D^-1 (b - A x0), no grid barrier; Jacobi and
    # power return x0 or v without a launch
    cases += [(name, n, 1, 0) for name, (n, _) in timed.items()
              if name.startswith("dense_neumann")]
    cases += [(name, n, 1, 0)
              for name in ("dense_jacobi_fused", "dense_power_fused")
              for n in DENSE_SIZES + (N_DENSE_GLOBAL,)]
    dense_fns = {}  # the calls phase 28 profiles, at the timed shapes
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

    solver_family(torch, slt, K, A, b, S, A_big, b_big, launches)
    W, rmat_fig = graph_phase(torch, slt, K, launches, smi)
    late["csr_spmv"].append(rmat_fig)
    query_phase(torch, slt, K, A, b, r_main, launches, smi)
    graph = flow_phase(torch, slt, K, launches, smi)
    utility_phase(torch, slt, K, A, b, r_main, W, launches, smi)
    del W

    phase("28 device times of the sparse products, the chains and the dense "
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
    for name in timed:
        dev_ms[name], per_call = device_profile(torch, dense_fns[name],
                                                kernel="dense_fused_kernel")
        _, every = device_profile(torch, dense_fns[name])
        n, B = timed[name]
        b_ms, b_by = bounds[name]
        print(f"  {name} at n={n} B={B} iters={DENSE_ITERS}: device "
              f"{fmt_ms(dev_ms[name])} ms per call, {per_call} device "
              f"launches per call ({every} of any kernel); per call "
              f"{ms[name]:.5f} ms; bound {b_ms:.5f} ms ({b_by})", flush=True)
        if not per_call == every == 1:
            raise RuntimeError(f"{name}: {every} device launches per call, "
                               f"{per_call} of dense_fused_kernel; the "
                               f"persistent kernel is one")
    del late  # its figures hold their operators on the card

    ref = cli_phase(torch, slt, K, A, b, S, launches, smi)
    mcp_phase(torch, slt, K, A, b, S, ref, graph, launches, smi)
    del graph
    http_phase(torch, slt, K, S, b, launches, smi)
    bench_phase(torch, slt, K, launches, smi)
    models_phase(torch, slt, K, launches, smi)

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
    print(f"script seconds: {time.perf_counter() - t_script:.1f}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
