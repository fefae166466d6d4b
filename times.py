#!/usr/bin/env python3
"""Time the chain and dense kernels of one checkout's port on one CUDA card.

    python3 times.py [--root DIR] [--family chains|dense|all]

Imports ``sublinear_tpu_torch`` from DIR (default: this checkout) and builds
its kernels there.  The calls timed have had the same API in every checkout
since these kernels were ported, so two checkouts (a parent and a change)
can be measured in one call on one card, in turns.  The last line is a JSON
object of every reading.

``chains``: ``neumann_chain(inv_d * b, 12, "norm")`` on the headline
matrices of chip_smoke.py (random-sparse, seed 7, n=100k density 1e-4 and
n=1M density 1e-5) and ``cg_chain(., 10)`` on their SPD forms.  For each
chain and size, per step: the time per back-to-back call (CUDA events, host
work included), the device time of the whole call (torch.profiler: every
kernel, copy and fill of the wrapper) and of the chain's kernels alone, the
bound (chip_smoke.py's chain_bounds), and the launches of one call.

``dense``: each wrapper of ``ops/dense_fused.py`` on chip_smoke.py's inputs
(the generator's random-sparse matrices, density 0.01, seed 7, stored dense;
a seeded column-stochastic P^T for dense_power_fused) at the shape
chip_smoke.py reports it at (B=1, iters=8; dense_neumann_fused at n=768, the
other three at n=1536): the time per back-to-back call and the device time
of the whole call with its device launches per call.  Each also at B=4,
and at B=1 with iters 0 and 1.  For the two Neumann kernels iters=0 is a
call's fixed cost (the launch, the load of A and the init product), and
iters=8 less iters=0, over 8, the cost of one iteration with its grid
barrier.  Jacobi and power launch nothing at iters=0 (a copy of x0 or v):
iters=1 is their fixed cost with one product, and iters=8 less iters=1,
over 7, the cost of one iteration.
Then three profiled warm solve_neumann_fused calls at n=768 (epsilon 1e-6):
wall time, device busy time and idle share.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from chip_smoke import (CG_ITERS, CHAIN_ITERS, DENSE_ITERS, DENSITY_DENSE,
                        DENSITY_LARGE, DENSITY_MAIN, N_LARGE, N_MAIN, SEED,
                        chain_bounds, dense_dd, device_ms, device_profile,
                        fmt_ms, profile_solve, stochastic, symmetric_dd,
                        time_ms)

# the chains' kernels by name: the cooperative kernels
# (neumann_chain_kernel, cg_chain_kernel) and the per-step kernels before
# them (neumann_step_kernel; cg_spmv_dot_, cg_update_, cg_direction_kernel)
CHAIN_KERNELS = {"neumann_step": "neumann_", "cg_step": "cg_"}
# (n, B, iters) of each dense wrapper, its chip_smoke.py shape first
DENSE_SHAPES = {
    "dense_neumann_fused": [(768, 1, DENSE_ITERS), (768, 4, DENSE_ITERS),
                            (768, 1, 0), (768, 1, 1)],
    "dense_neumann_fused_bf16x3": [(1536, 1, DENSE_ITERS),
                                   (1536, 4, DENSE_ITERS), (1536, 1, 0),
                                   (1536, 1, 1)],
    "dense_jacobi_fused": [(1536, 1, DENSE_ITERS), (1536, 4, DENSE_ITERS),
                           (1536, 1, 0), (1536, 1, 1)],
    "dense_power_fused": [(1536, 1, DENSE_ITERS), (1536, 4, DENSE_ITERS),
                          (1536, 1, 0), (1536, 1, 1)],
}


def time_chains(torch, slt, readings):
    from sublinear_tpu_torch.ops import csr_spmv as K

    for n, density, reps in ((N_MAIN, DENSITY_MAIN, 200),
                             (N_LARGE, DENSITY_LARGE, 20)):
        A = slt.generate("random-sparse", n, seed=SEED, density=density)
        b = slt.rhs(n, seed=SEED)
        S = symmetric_dd(slt, *A.csr.to_coo(), n)
        op, sop = A.op(), S.op()
        t0 = op.inv_diag * A.pad_vector(b)
        bs = S.pad_vector(b)
        zs = sop.inv_diag * bs
        cg0 = (torch.zeros_like(bs), bs, zs, K.dot64(bs, zs))
        for name, fn, steps, o in (
                ("neumann_step",
                 lambda: K.neumann_chain(op, t0, CHAIN_ITERS, "norm"),
                 CHAIN_ITERS, op),
                ("cg_step", lambda: K.cg_chain(sop, *cg0, CG_ITERS),
                 CG_ITERS, sop)):
            before = K.LAUNCHES[name]
            fn()
            launches = K.LAUNCHES[name] - before
            call = time_ms(torch, fn, reps) / steps
            whole = device_ms(torch, fn)
            alone = device_ms(torch, fn, kernel=CHAIN_KERNELS[name])
            b_ms, b_by = chain_bounds(o)[name]
            row = {"per_call_ms": call,
                   "device_ms": None if whole is None else whole / steps,
                   "kernels_device_ms":
                       None if alone is None else alone / steps,
                   "bound_ms": b_ms, "bound_by": b_by,
                   "launches_per_chain": launches, "steps": steps}
            readings[f"{name} n={n}"] = row
            print(f"{name} n={n}: {row}", flush=True)
        del A, S, op, sop, t0, bs, zs, cg0


def time_dense(torch, slt, readings, out):
    from sublinear_tpu_torch.ops import dense_fused as DF
    from sublinear_tpu_torch.solvers.fused import solve_neumann_fused

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    mats = {}
    for name, shapes in DENSE_SHAPES.items():
        fn = getattr(DF, name)
        for n, B, iters in shapes:
            if name == "dense_power_fused":
                pt, v, dang = stochastic(torch, n, B, dev)
                args = (pt, v, dang, 0.85, iters)
            else:
                if n not in mats:
                    mats[n] = dense_dd(torch, slt, n, dev)
                a, d, dinv = mats[n]
                b, x0 = (torch.as_tensor(s * rng.standard_normal((n, B)),
                                         dtype=torch.float32, device=dev)
                         for s in (1.0, 0.1))
                mat = DF.split_bf16(a) if name.endswith("bf16x3") else (a,)
                args = (*mat, d, dinv, b, x0, iters)
            call = lambda fn=fn, args=args: fn(*args)  # noqa: E731
            ms = time_ms(torch, call, 200)
            dev_ms, launches = device_profile(torch, call)
            label = f"{name} n={n} B={B} iters={iters}"
            readings[label] = {"ms": ms, "device_ms": dev_ms,
                               "device_launches": launches}
            print(f"{label}: per call {ms:.5f} ms, device {fmt_ms(dev_ms)} "
                  f"ms in {launches} launches", flush=True)
    M = slt.generate("random-sparse", 768, seed=SEED, density=DENSITY_DENSE)
    b_m = slt.rhs(768, seed=SEED)
    opts = slt.SolverOptions(epsilon=1e-6)
    r = solve_neumann_fused(M, b_m, opts)
    print(f"solve_neumann_fused n=768: {r.method}, {r.iterations} "
          f"iterations", flush=True)
    out.mkdir(parents=True, exist_ok=True)
    for i in range(3):
        profile_solve(torch, lambda: solve_neumann_fused(M, b_m, opts),
                      out / f"fused_solve_n768_{i}.json")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).parent,
                    help="the checkout whose sublinear_tpu_torch to time")
    ap.add_argument("--family", choices=("chains", "dense", "all"),
                    default="all", help="the kernels to time")
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no card")
    import sublinear_tpu_torch as slt

    if Path(slt.__file__).resolve().parent.parent != root:
        raise RuntimeError(f"imported {slt.__file__}, not from {root}")
    readings = {"root": str(root), "device": torch.cuda.get_device_name(0)}
    if args.family in ("chains", "all"):
        time_chains(torch, slt, readings)
    if args.family in ("dense", "all"):
        time_dense(torch, slt, readings, root / "build" / "times")
    print(json.dumps(readings), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
