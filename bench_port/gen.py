"""The benchmark's own seeded generators.

Everything a run feeds the port is made here from ``--seed``, on the run's
device, in a few large calls of one ``torch.Generator``, and then copied to
the host once: the port takes NumPy arrays at its public API.  The arithmetic
follows ``sublinear_tpu_torch/generate.py::random_sparse`` (the reference's
``random-sparse`` recipe) and Graph500's R-MAT generator, but none of the
port's code runs here.

A configuration file names its ``kind``; ``KINDS`` maps the two kinds here
to their generators, and any other kind is the file ``kinds/<kind>.py``,
whose ``make(cfg, g, device)`` may use this module's helpers
(``generator``, ``_to_data``).  Every generator returns a ``Data``: the COO
triplets as the port receives them (where a generator repeats an entry, both
the port and the reference sum the repeats), with the stored-entry count
after summing.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import lookup

SEED_MASK = (1 << 64) - 1


@dataclasses.dataclass
class Data:
    n: int
    rows: np.ndarray   # int64
    cols: np.ndarray   # int64
    vals: np.ndarray   # float64
    nnz: int           # stored entries once duplicates are summed
    nnz_diag: int      # of those, on the diagonal


def generator(seed: int, device) -> torch.Generator:
    """The run's one generator: any whole number is a seed (taken mod 2^64)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & SEED_MASK)
    return g


def _stored(rows: torch.Tensor, cols: torch.Tensor, n: int) -> tuple[int, int]:
    keys = torch.unique(rows * n + cols)
    return keys.numel(), int(((keys // n) == (keys % n)).sum())


def _to_data(n, rows, cols, vals) -> Data:
    nnz, nnz_diag = _stored(rows, cols, n)
    return Data(n, rows.cpu().numpy(), cols.cpu().numpy(),
                vals.cpu().numpy(), nnz, nnz_diag)


def random_sparse(cfg: dict, g: torch.Generator, device) -> Data:
    """Off-diagonal entries at positions uniform over i != j, values
    U(-1, 1), and the diagonal ``diag_scale`` * |off-diagonal row sum| +
    ``diag_shift``.  The entry count is fixed at its expectation,
    round(density * n * (n - 1)), so every seed does the same work (the
    reference draws it from a binomial)."""
    n = int(cfg["n"])
    count = round(float(cfg["density"]) * n * (n - 1))
    rows = torch.randint(0, n, (count,), generator=g, device=device)
    cols = torch.randint(0, n - 1, (count,), generator=g, device=device)
    cols = cols + (cols >= rows).long()
    vals = torch.rand(count, generator=g, device=device,
                      dtype=torch.float64) * 2.0 - 1.0
    # row sums on the host: bincount adds in a fixed order, so the diagonal
    # is the same to the last bit in every run of a seed
    row_sums = np.bincount(rows.cpu().numpy(), weights=np.abs(vals.cpu().numpy()),
                           minlength=n)
    diag = torch.from_numpy(row_sums * float(cfg["diag_scale"])
                            + float(cfg["diag_shift"])).to(device)
    d = torch.arange(n, device=device)
    return _to_data(n, torch.cat([rows, d]), torch.cat([cols, d]),
                    torch.cat([vals, diag]))


def rmat(cfg: dict, g: torch.Generator, device) -> Data:
    """Graph500's R-MAT: each edge picks one quadrant per bit of
    ``scale`` with probabilities a, b, c, 1 - a - b - c; the ids are then
    scrambled by a seeded permutation of 2^scale, edges with an end at or
    past n, self-loops and repeats of an edge already drawn are dropped, and
    the first ``edges`` distinct edges that remain are kept, with weight 1."""
    n, edges, scale = int(cfg["n"]), int(cfg["edges"]), int(cfg["scale"])
    a, b, c = float(cfg["a"]), float(cfg["b"]), float(cfg["c"])
    m = int(edges * float(cfg["oversample"]))
    rows = torch.zeros(m, dtype=torch.int64, device=device)
    cols = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(scale):
        u = torch.rand(m, generator=g, device=device, dtype=torch.float64)
        rows |= (u >= a + b).long() << bit
        cols |= (((u >= a) & (u < a + b)) | (u >= a + b + c)).long() << bit
    perm = torch.randperm(1 << scale, generator=g, device=device)
    rows, cols = perm[rows], perm[cols]
    keep = torch.nonzero((rows < n) & (cols < n) & (rows != cols))[:, 0]
    rows, cols = rows[keep], cols[keep]
    # each distinct edge at the place it was first drawn, in draw order
    _, inverse = torch.unique(rows * n + cols, return_inverse=True)
    first = torch.full((int(inverse.max()) + 1,), rows.numel(),
                       dtype=torch.int64, device=device)
    first.scatter_reduce_(0, inverse, torch.arange(rows.numel(), device=device),
                          "amin")
    if first.numel() < edges:
        raise RuntimeError(f"R-MAT kept {first.numel()} distinct edges < "
                           f"{edges}: raise 'oversample'")
    first = torch.sort(first).values[:edges]
    rows, cols = rows[first], cols[first]
    return _to_data(n, rows, cols,
                    torch.ones(edges, dtype=torch.float64, device=device))


KINDS = {"random-sparse": random_sparse, "rmat": rmat}


def kind(name: str):
    """The generator of kind ``name``: ``KINDS``, else the ``make`` of
    ``kinds/<name>.py``."""
    return lookup.find(KINDS, "gen.KINDS", lookup.KINDS_DIR, name, "make")


def make(cfg: dict, g: torch.Generator, device) -> Data:
    return kind(cfg["kind"])(cfg, g, device)


def uniform_block(shape, g: torch.Generator, device) -> np.ndarray:
    """U(-1, 1) float64 numbers of ``shape`` (the reference's ``rhs``
    recipe), made on the device and returned on the host."""
    return (torch.rand(shape, generator=g, device=device, dtype=torch.float64)
            * 2.0 - 1.0).cpu().numpy()


def draw(values: np.ndarray, count: int, g: torch.Generator, device) -> np.ndarray:
    """``count`` draws with replacement from ``values``."""
    idx = torch.randint(0, values.size, (count,), generator=g, device=device)
    return values[idx.cpu().numpy()]
