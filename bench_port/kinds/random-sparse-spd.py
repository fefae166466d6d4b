"""The headline system made symmetric positive definite.

Off-diagonal entries at round(density * n * (n - 1) / 2) positions, each
uniform over the strict upper triangle i < j, values U(-1, 1), every one
mirrored to (j, i) with the identical value; the diagonal is
``diag_scale`` * |off-diagonal row sum| + ``diag_shift`` over the mirrored
rows.  So the matrix is exactly symmetric (the port's ``is_symmetric`` test
sends it to CG) and strictly diagonally dominant with a positive diagonal,
hence SPD.  The count is fixed, so every seed does the same work: at the
headline's n = 100,000 and density 1e-4, 499,995 positions and 999,990
stored off-diagonal entries, the count of ``gen.random_sparse``.
"""
from __future__ import annotations

import numpy as np
import torch

from bench_port import gen


def make(cfg: dict, g: torch.Generator, device) -> gen.Data:
    n = int(cfg["n"])
    count = round(float(cfg["density"]) * n * (n - 1) / 2)
    # an ordered pair uniform over i != j, sorted, is uniform over i < j
    a = torch.randint(0, n, (count,), generator=g, device=device)
    b = torch.randint(0, n - 1, (count,), generator=g, device=device)
    b = b + (b >= a).long()
    upper, lower = torch.minimum(a, b), torch.maximum(a, b)
    vals = torch.rand(count, generator=g, device=device,
                      dtype=torch.float64) * 2.0 - 1.0
    rows, cols = torch.cat([upper, lower]), torch.cat([lower, upper])
    vals = torch.cat([vals, vals])
    # row sums on the host: bincount adds in a fixed order, so the diagonal
    # is the same to the last bit in every run of a seed
    row_sums = np.bincount(rows.cpu().numpy(), weights=np.abs(vals.cpu().numpy()),
                           minlength=n)
    diag = torch.from_numpy(row_sums * float(cfg["diag_scale"])
                            + float(cfg["diag_shift"])).to(device)
    d = torch.arange(n, device=device)
    return gen._to_data(n, torch.cat([rows, d]), torch.cat([cols, d]),
                        torch.cat([vals, diag]))
