"""Random-walk Monte Carlo solver, as in ``sublinear_tpu/solvers/random_walk.py``.

All walkers for all requested coordinates advance in lockstep as vectors on
the device.  The estimator is the accumulation form of the Neumann series
x = sum_t M^t c (M = -D^-1 R, c = D^-1 b):

    acc += w_t * c[pos_t],   w_{t+1} = w_t * sign(m) * S[pos_t]

with the next node drawn from the row CDF of |M| (probability |m_jk|/S_j, so
the importance weight is exactly sign * S_j).  Walks stop when every walker
has |w| <= w_min, or at max_walk_length.  Antithetic pairs share u <-> 1-u.

The JAX package runs the walk in one ``lax.while_loop`` on the device.
Here a host loop enqueues blocks of ``WALK_BLOCK`` steps; an on-device
``alive`` flag, computed as the JAX loop's condition, freezes the walkers
and the step count once it turns false, and the host reads it once per
block: the reference's stopping step without a read per step.  The u's come
from a ``torch.Generator`` on the walkers' device, seeded from
``options.seed``, so a rerun with one seed is bit-identical; the streams
differ from ``jax.random``'s, so estimates match the reference in
distribution, not sample for sample.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_dtype, to_device
from ..errors import MemoryLimitError
from ..formats.streaming import memory_budget_bytes
from ..matrix import Matrix
from ..types import SolverOptions, SolverResult
from ..utils.lru import LRUCache
from . import base

WALK_CAP = 10_000  # cap on the reference's 1/eps^2 walk-count rule
W_MIN = 1e-4       # a walker with |w| <= W_MIN is done
WALK_BLOCK = 8     # walk steps enqueued per read of the alive flag
CV_HEAD_STEPS = 8  # deterministic head length for control variates
_GOLDEN = 0.6180339887498949  # 1/phi, additive-recurrence QMC stride


def default_num_walks(options: SolverOptions) -> int:
    if options.num_walks is not None:
        return int(options.num_walks)
    return int(max(100, min(1.0 / (options.epsilon**2), WALK_CAP)))


class SamplingTables:
    """Row-major CDF sampling tables for the iteration matrix M = -D^-1 R,
    on the matrix's device."""

    def __init__(self, cols, cdf, sign, S, n_pad, mval, k_row):
        self.cols = cols    # (n_pad, K) int32
        self.cdf = cdf      # (n_pad, K) cumulative probabilities in [0, 1]
        self.sign = sign    # (n_pad, K) +-1
        self.S = S          # (n_pad,) row l1 mass of M
        self.n_pad = n_pad
        self.mval = mval    # (n_pad, K) signed entries of M (uniform IS weights)
        self.k_row = k_row  # (n_pad,) nonzero slot count per row


# bounded: serving processes touch many distinct matrices
_TABLE_CACHE = LRUCache(maxsize=32)


def estimate_table_bytes(matrix: Matrix) -> int:
    """Device bytes of the sampling tables: 4 (n, K) planes + 2 (n,)
    vectors of 4-byte entries (the port does not pad n)."""
    row_nnz = matrix.csr.row_nnz()
    K = max(int(row_nnz.max()) if row_nnz.size else 1, 1)
    n = max(matrix.shape[0], 1)
    return 4 * n * K * 4 + 2 * n * 4


def sampling_tables(matrix: Matrix, dtype=None) -> SamplingTables:
    """The tables of ``matrix`` (built with NumPy as the JAX package builds
    them, then moved to the device), cached per (matrix, dtype); raises
    E007 when they would exceed the device budget."""
    dt = resolve_dtype(dtype)
    key = (matrix.uid, str(dt))
    hit = _TABLE_CACHE.get(key)
    if hit is not None:
        return hit
    need = estimate_table_bytes(matrix)
    limit = memory_budget_bytes(matrix.device)
    if need > limit:
        raise MemoryLimitError(
            f"walker sampling tables need ~{need/1e9:.2f} GB > device budget "
            f"{limit/1e9:.2f} GB; reduce max row degree (RCM/split hub rows) "
            f"or raise SLT_MEMORY_LIMIT_BYTES",
            {"requiredBytes": need, "budgetBytes": limit, "kind": "walk-tables"},
        )
    csr = matrix.csr
    n = csr.shape[0]
    n_pad = matrix.op(dt).n_pad

    rows = csr.row_of_entry()
    diag = csr.diagonal_vector()
    off = csr.indices != rows
    o_rows, o_cols, o_vals = rows[off], csr.indices[off], csr.data[off]
    m_vals = -o_vals / diag[o_rows]

    row_cnt = np.zeros(n, dtype=np.int64)
    np.add.at(row_cnt, o_rows, 1)
    K = max(int(row_cnt.max()) if row_cnt.size else 1, 1)
    # position of each entry within its row (entries are in CSR order)
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(row_cnt, out=starts[1:])
    pos = np.arange(o_rows.size) - starts[o_rows]

    absm = np.zeros((n_pad, K))
    sign = np.ones((n_pad, K))
    mval = np.zeros((n_pad, K))
    cols = np.zeros((n_pad, K), dtype=np.int32)
    absm[o_rows, pos] = np.abs(m_vals)
    sign[o_rows, pos] = np.where(m_vals >= 0, 1.0, -1.0)
    mval[o_rows, pos] = m_vals
    cols[o_rows, pos] = o_cols

    S = absm.sum(axis=1)
    safe = np.where(S > 0, S, 1.0)
    cdf = np.cumsum(absm / safe[:, None], axis=1)
    cdf[:, -1] = 1.0 + 1e-6  # guard: u==1 still lands in the last slot
    k_row = np.zeros(n_pad)
    k_row[:n] = row_cnt

    dev = matrix.device
    tables = SamplingTables(
        to_device(cols, torch.int32, dev), to_device(cdf, dt, dev),
        to_device(sign, dt, dev), to_device(S, dt, dev), n_pad,
        to_device(mval, dt, dev), to_device(k_row, dt, dev))
    _TABLE_CACHE.put(key, tables)
    return tables


def _walk_batch(tables_tuple, c, starts, seed, max_len, antithetic,
                strategy="importance", t_start=0, group=0):
    """Advance all walkers to termination.  starts: (W,) int64 start nodes
    on ``c``'s device.

    strategy (lane-parallel estimators):
      importance - next node ~ |m_jk|/S_j (exactly-known IS weight sign*S);
      uniform    - next node uniform over the row's nonzeros, IS weight m*k;
      stratified - importance CDF driven by per-group stratified u
                   (group = walks per start node);
      qmc        - importance CDF driven by a randomized golden-ratio
                   additive recurrence (Cranley-Patterson shifted).
    t_start: accumulate only steps t >= t_start (multilevel tail estimator).
    Returns per-walker accumulated estimates (W,) and the step count."""
    cols, cdf, sign, S, mval, k_row = tables_tuple
    W, K = starts.numel(), cols.shape[1]
    dt, dev = c.dtype, c.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    def rand():
        return torch.rand(W, generator=gen, device=dev, dtype=dt)

    qmc_shift = rand() if strategy == "qmc" else None
    lane = (torch.arange(W, device=dev) % group).to(dt) if group > 1 else None
    half = W // 2

    def gen_u(j):
        if strategy == "qmc":
            # (t + 1) * golden rounded to dt, as the JAX loop computes it
            stride = float(torch.tensor(j + 1.0, dtype=dt)
                           * torch.tensor(_GOLDEN, dtype=dt))
            u = torch.remainder(qmc_shift + stride, 1.0)
        elif strategy == "stratified" and group > 1:
            u = (lane + rand()) / float(group)
        else:
            u = rand()
        if antithetic:
            u = torch.cat([u[:half], 1.0 - u[:half], u[2 * half:]])
        return u

    pos = starts.clone()
    w = torch.ones(W, dtype=dt, device=dev)
    acc = torch.zeros(W, dtype=dt, device=dev)
    t = torch.zeros((), dtype=torch.int64, device=dev)
    alive = torch.ones((), dtype=torch.bool, device=dev)
    step = 0
    while step < max_len:
        end = min(step + WALK_BLOCK, max_len)
        for j in range(step, end):
            # the JAX loop's condition; t < max_len holds by the host loop
            alive = alive & torch.any(w.abs() > W_MIN)
            if j >= t_start:
                acc = torch.where(alive, acc + w * c[pos], acc)
            u = gen_u(j)
            k_here, s_here = k_row[pos], S[pos]
            row_base = pos * K
            if strategy == "uniform":
                slot = torch.clamp(torch.floor(u * k_here).long(), 0, K - 1)
                w_new = w * mval.view(-1)[row_base + slot] * k_here
            else:
                row_cdf = cdf.index_select(0, pos)           # (W, K)
                slot = torch.sum(u[:, None] >= row_cdf, dim=1)
                slot = torch.clamp(slot, max=K - 1)
                w_new = w * sign.view(-1)[row_base + slot] * s_here
            nxt = cols.view(-1)[row_base + slot].long()
            live_row = s_here > 0  # dangling rows terminate
            w = torch.where(alive, torch.where(live_row, w_new, 0.0), w)
            pos = torch.where(alive & live_row, nxt, pos)
            t = t + alive
        step = end
        # the one device-to-host read per block: the next step's condition
        if step < max_len and not bool(alive & torch.any(w.abs() > W_MIN)):
            break
    return acc, int(t)


def _walk_inputs(matrix: Matrix, b, options: SolverOptions):
    t = sampling_tables(matrix, options.dtype)
    op = matrix.op(options.dtype)
    c = op.inv_diag * matrix.pad_vector(b, options.dtype)
    return (t.cols, t.cdf, t.sign, t.S, t.mval, t.k_row), c


def max_walkers_for_memory(K: int, dtype_bytes: int = 4, frac: float = 0.25,
                           device=None) -> int:
    """Largest walker batch whose per-step working set fits in ``frac`` of the
    E007 device budget.  Each lockstep step materializes ~4 gathered (W, K)
    planes plus a handful of (W,) vectors."""
    per_walker = 4 * max(K, 1) * dtype_bytes + 16 * dtype_bytes
    cap = int(memory_budget_bytes(device) * frac) // per_walker
    return max(cap, 256)


def run_walks(matrix: Matrix, b, starts_np, options: SolverOptions, *,
              strategy=None, t_start=0, max_len=None, seed_offset=0, group=0):
    """Raw per-walker accumulations (float64 numpy) for an arbitrary
    start-node multiset, and the steps taken.  Batches larger than the
    device-memory walker cap are split into chunks aligned to ``group`` (and
    to antithetic pairs), chunk ``i`` seeded ``seed + seed_offset +
    0xC41 * i``."""
    tup, c = _walk_inputs(matrix, b, options)
    strategy = strategy or options.sampling
    anti = (options.variance_reduction == "antithetic"
            and strategy not in ("stratified", "qmc"))
    max_len = (int(min(options.max_walk_length, 512)) if max_len is None
               else int(max_len))
    starts = np.asarray(starts_np, dtype=np.int64).reshape(-1)
    W_total = starts.size
    K = int(tup[0].shape[1])
    cap = max_walkers_for_memory(K, dtype_bytes=c.element_size(),
                                 device=c.device)
    align = max(int(group), 1)
    if anti:
        align = max(align, 2)
    cap = max((cap // align) * align, align)

    seed = int(options.seed) + seed_offset
    accs, t_max = [], 0
    for ci, lo in enumerate(range(0, max(W_total, 1), cap)):
        chunk = to_device(starts[lo: lo + cap], torch.int64, c.device)
        acc, t = _walk_batch(tup, c, chunk, seed + 0xC41 * ci,
                             max_len, anti, strategy=strategy,
                             t_start=int(t_start), group=int(group))
        accs.append(acc.cpu().double().numpy())
        t_max = max(t_max, t)
    return np.concatenate(accs), t_max


def _head_partial_sum(op, c, t0: int):
    """Exact sum_{t<t0} M^t c via t0 products (M v = -D^-1 (A - D) v)."""
    term, acc = c, torch.zeros_like(c)
    for _ in range(t0):
        acc = acc + term
        term = -op.inv_diag * (op.matvec(term) - op.diag * term)
    return acc


def cv_walk_estimate(matrix: Matrix, b, start_nodes, options: SolverOptions):
    """Control-variates estimator: the exact truncated head of the Neumann
    series (T0 products) plus the MC tail (walks accumulating from step
    T0), whose variance is smaller by ~S^(2 T0) for row mass S < 1."""
    start_nodes = np.asarray(start_nodes, dtype=np.int64).reshape(-1)
    W = default_num_walks(options)
    T0 = int(min(CV_HEAD_STEPS, max(options.max_walk_length // 4, 1)))
    op = matrix.op(options.dtype)
    c = op.inv_diag * matrix.pad_vector(b, options.dtype)
    head = _head_partial_sum(op, c, T0).cpu().double().numpy()
    starts = np.repeat(start_nodes, W)
    tail, t = run_walks(matrix, b, starts, options, t_start=T0, group=W)
    tail = tail.reshape(start_nodes.size, W)
    est = head[start_nodes] + tail.mean(axis=1)
    var = tail.var(axis=1, ddof=1) if W > 1 else np.zeros(start_nodes.size)
    return est, var, t


def walk_estimate(matrix: Matrix, b, start_nodes, options: SolverOptions):
    """MC estimates of x[start_nodes]; returns (estimates, variance, steps)."""
    start_nodes = np.asarray(start_nodes, dtype=np.int64).reshape(-1)
    if options.sampling == "adaptive":
        from .sampling import adaptive_walk_estimate

        return adaptive_walk_estimate(matrix, b, start_nodes, options)
    if options.variance_reduction == "control-variates":
        return cv_walk_estimate(matrix, b, start_nodes, options)
    W = default_num_walks(options)
    starts = np.repeat(start_nodes, W)
    acc, t = run_walks(matrix, b, starts, options, group=W)
    acc = acc.reshape(start_nodes.size, W)
    est = acc.mean(axis=1)
    var = acc.var(axis=1, ddof=1) if W > 1 else np.zeros_like(est)
    return est, var, t


def solve_random_walk(matrix: Matrix, b, options: SolverOptions,
                      raise_on_fail: bool = True) -> SolverResult:
    n = matrix.shape[0]
    threshold = base.threshold_for(b, options)
    with base.SolveTimer(matrix.device) as t:
        est, var, steps = walk_estimate(matrix, b, np.arange(n), options)
    res = float(np.linalg.norm(matrix.csr.matvec(est)
                               - np.asarray(b, dtype=np.float64)))
    result = SolverResult(
        solution=est,
        iterations=steps,
        residual=res,
        converged=res <= threshold,
        method="random-walk",
        compute_time_ms=t.ms,
    )
    return base.check_outcome(result, threshold, options, raise_on_fail)
