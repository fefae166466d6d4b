"""Sampling strategies for Monte-Carlo solution estimation, as in
``sublinear_tpu/solvers/sampling.py``.

Strategies are batch generators: every strategy produces one lock-step
walker batch (``random_walk._walk_batch``), whose u-sequence (uniform,
stratified or randomized golden-ratio QMC) and proposal (importance = row
CDF of |M|, uniform = uniform over the nonzeros with exact IS correction)
live on the device.  This module holds the two estimators that need host
allocation logic:

- adaptive_walk_estimate: two-phase Neyman allocation.  A pilot batch
  measures per-coordinate variance; the remaining walk budget is allocated
  proportionally to the pilot standard deviations.
- multilevel_estimate: MLMC over walk-length levels.  Level 0 estimates the
  series truncated at L0 steps; level l>0 estimates the tail contribution of
  steps (L_{l-1}, L_l] with geometrically fewer walkers.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from ..matrix import Matrix
from ..types import SolverOptions


@dataclass
class SamplingStats:
    """Per-phase sampling statistics (reference sampling.rs:325-361)."""

    total_walks: int = 0
    phases: List[dict] = field(default_factory=list)

    def record(self, name: str, walks: int, mean_var: float):
        self.total_walks += int(walks)
        self.phases.append({"phase": name, "walks": int(walks), "mean_variance": float(mean_var)})


def adaptive_walk_estimate(matrix: Matrix, b, start_nodes, options: SolverOptions,
                           pilot_frac: float = 0.25, stats: SamplingStats | None = None):
    """Two-phase variance-adaptive estimation of x[start_nodes].

    Returns (estimates, variances, steps) like walk_estimate."""
    from .random_walk import default_num_walks, run_walks

    start_nodes = np.asarray(start_nodes, dtype=np.int32).reshape(-1)
    G = start_nodes.size
    W = default_num_walks(options)
    budget = G * W
    W0 = max(16, int(W * pilot_frac))

    # Phase 1: uniform pilot allocation (importance proposals).
    pilot_starts = np.repeat(start_nodes, W0)
    acc0, t0 = run_walks(matrix, b, pilot_starts, options, strategy="importance", group=W0)
    acc0 = acc0.reshape(G, W0)
    mean0 = acc0.mean(axis=1)
    var0 = acc0.var(axis=1, ddof=1)
    if stats is not None:
        stats.record("pilot", G * W0, float(var0.mean()))

    # Phase 2: Neyman allocation of the remaining budget ~ pilot std.
    remaining = max(budget - G * W0, 0)
    std = np.sqrt(np.maximum(var0, 0.0))
    if remaining == 0 or std.sum() == 0:
        return mean0, var0, t0
    alloc = np.maximum(np.round(remaining * std / std.sum()).astype(np.int64), 0)
    refine_starts = np.repeat(start_nodes, alloc)
    if refine_starts.size == 0:
        return mean0, var0, t0
    acc1, t1 = run_walks(matrix, b, refine_starts, options, strategy="importance",
                         seed_offset=0x51ED)
    if stats is not None:
        stats.record("refine", refine_starts.size, float(np.var(acc1)))

    # Pooled mean/variance per coordinate across both phases.
    est = np.empty(G)
    var = np.empty(G)
    offsets = np.concatenate([[0], np.cumsum(alloc)])
    for g in range(G):
        samples = np.concatenate([acc0[g], acc1[offsets[g]:offsets[g + 1]]])
        est[g] = samples.mean()
        var[g] = samples.var(ddof=1) if samples.size > 1 else var0[g]
    return est, var, max(t0, t1)


def multilevel_estimate(matrix: Matrix, b, start_nodes, options: SolverOptions,
                        levels: int = 3, base_len: int = 8, decay: float = 4.0,
                        stats: SamplingStats | None = None):
    """MLMC estimate of x[start_nodes] over walk-length levels.

    Level boundaries L_l = base_len * 2^l; level l uses W / decay^l walkers.
    Unbiased for the series truncated at L_{levels-1} (tail beyond that is
    bounded by the geometric Neumann tail, negligible for DD systems).
    Returns (estimates, variances, steps)."""
    from .random_walk import default_num_walks, run_walks

    start_nodes = np.asarray(start_nodes, dtype=np.int32).reshape(-1)
    G = start_nodes.size
    W = default_num_walks(options)

    est = np.zeros(G)
    var = np.zeros(G)
    t_max = 0
    prev_len = 0
    for lvl in range(levels):
        L = base_len * (2**lvl)
        Wl = max(8, int(W / (decay**lvl)))
        starts = np.repeat(start_nodes, Wl)
        acc, t = run_walks(matrix, b, starts, options, strategy="importance",
                           t_start=prev_len, max_len=L, seed_offset=0x7A11 + lvl, group=Wl)
        acc = acc.reshape(G, Wl)
        est += acc.mean(axis=1)
        var += acc.var(axis=1, ddof=1) / Wl  # variance of the level mean
        if stats is not None:
            stats.record(f"level{lvl}[{prev_len},{L})", G * Wl, float(acc.var().mean()))
        t_max = max(t_max, t)
        prev_len = L
    return est, var, t_max
