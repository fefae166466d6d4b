#!/usr/bin/env python3
"""Time the two CSR chain kernels of one checkout's port on one CUDA card.

    python3 chain_times.py [--root DIR]

Imports ``sublinear_tpu_torch`` from DIR (default: this checkout), builds
its kernels there, and times ``neumann_chain(inv_d * b, 12, "norm")`` on the
headline matrices of chip_smoke.py (random-sparse, seed 7, n=100k density
1e-4 and n=1M density 1e-5) and ``cg_chain(., 10)`` on their SPD forms.
The API of the two chains is the same in every checkout since the port
began, so two checkouts (a parent and a change) can be measured in one call
on one card, in turns.  For each chain and size it reports per step: the
time per back-to-back call (CUDA events, host work included), the device
time of the whole call (torch.profiler: every kernel, copy and fill of the
wrapper) and of the chain's kernels alone, the bound (chip_smoke.py's
chain_bounds), and the launches of one call.  The last line is a JSON
object of every reading.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from chip_smoke import (CG_ITERS, CHAIN_ITERS, DENSITY_LARGE, DENSITY_MAIN,
                        N_LARGE, N_MAIN, SEED, chain_bounds, device_ms,
                        symmetric_dd, time_ms)

# the chains' kernels by name: this checkout's cooperative kernels
# (neumann_chain_kernel, cg_chain_kernel) and the per-step kernels before
# them (neumann_step_kernel; cg_spmv_dot_, cg_update_, cg_direction_kernel)
KERNEL_NAMES = {"neumann_step": "neumann_", "cg_step": "cg_"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).parent,
                    help="the checkout whose sublinear_tpu_torch to time")
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: no card")
    import sublinear_tpu_torch as slt
    from sublinear_tpu_torch.ops import csr_spmv as K

    if Path(slt.__file__).resolve().parent.parent != root:
        raise RuntimeError(f"imported {slt.__file__}, not from {root}")
    readings = {"root": str(root), "device": torch.cuda.get_device_name(0)}
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
            alone = device_ms(torch, fn, kernel=KERNEL_NAMES[name])
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
    print(json.dumps(readings), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
