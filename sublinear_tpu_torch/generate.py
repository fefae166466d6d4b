"""Test-matrix generators: a copy of ``sublinear_tpu/generate.py``.

The NumPy code is identical, so ``generate(..., seed=s)`` and
``rhs(n, seed=s)`` give bit-identical CSR and RHS arrays in both packages.

Semantics parity with the reference generators
(src/mcp/tools/matrix.ts:146-417 generateTestMatrix and the
Python fixture corpus scripts/linear_systems/test_matrices):

  - 'diagonally-dominant': 30% dense off-diagonals in (-1, 1),
    diag = strength * offdiag_abs_sum + 1
  - 'laplacian': random graph with edge prob `connectivity`, L = D - A
  - 'random-sparse': off-diagonals with prob `density`, values in (-1, 1),
    diag = 1.5 * row_abs_sum + 1 when dominance requested
  - 'tridiagonal': 2 on the diagonal, `off_diagonal` on the bands

All generators are seeded (NumPy PCG64) for reproducibility — the reference
uses unseeded Math.random(); we deliberately upgrade to deterministic
generation so fixtures are stable across runs.
"""
from __future__ import annotations

import numpy as np

from .errors import InvalidParametersError
from .matrix import Matrix


def generate(kind: str, size: int, seed: int = 0, **params) -> Matrix:
    kind = str(kind).strip().lower().replace("_", "-")
    if kind in ("diagonally-dominant", "dd"):
        return diagonally_dominant(size, strength=params.get("strength", 2.0), seed=seed)
    if kind == "laplacian":
        return laplacian(size, connectivity=params.get("connectivity", 0.1), seed=seed)
    if kind == "random-sparse":
        return random_sparse(
            size,
            density=params.get("density", 0.1),
            dominance=params.get("dominance", True),
            seed=seed,
        )
    if kind == "tridiagonal":
        return tridiagonal(size, off_diagonal=params.get("off_diagonal", -1.0))
    raise InvalidParametersError(f"Unknown test matrix type: {kind}")


def _sparse_offdiag(n: int, density: float, rng) -> tuple:
    """Sample off-diagonal (i, j, v) with P[entry] = density, v ~ U(-1, 1).

    Uses binomial count + uniform index sampling instead of an n^2 Bernoulli
    sweep so n=1e6 stays cheap."""
    expected = density * n * (n - 1)
    count = rng.binomial(max(n * (n - 1), 1), min(density, 1.0)) if n > 1 else 0
    if count == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0)
    rows = rng.integers(0, n, size=count)
    # sample j != i by offsetting into the remaining n-1 columns
    cols = rng.integers(0, n - 1, size=count)
    cols = np.where(cols >= rows, cols + 1, cols)
    vals = rng.uniform(-1.0, 1.0, size=count)
    return rows, cols, vals


def diagonally_dominant(n: int, strength: float = 2.0, seed: int = 0) -> Matrix:
    rng = np.random.default_rng(seed)
    rows, cols, vals = _sparse_offdiag(n, 0.3, rng)
    row_sums = np.zeros(n)
    np.add.at(row_sums, rows, np.abs(vals))
    d = np.arange(n)
    rows = np.concatenate([rows, d])
    cols = np.concatenate([cols, d])
    vals = np.concatenate([vals, strength * row_sums + 1.0])
    return Matrix.from_coo(rows, cols, vals, (n, n))


def laplacian(n: int, connectivity: float = 0.1, seed: int = 0) -> Matrix:
    rng = np.random.default_rng(seed)
    rows, cols, _ = _sparse_offdiag(n, connectivity, rng)
    vals = -np.ones(rows.size)
    degree = np.zeros(n)
    np.add.at(degree, rows, 1.0)
    d = np.arange(n)
    rows = np.concatenate([rows, d])
    cols = np.concatenate([cols, d])
    vals = np.concatenate([vals, degree])
    return Matrix.from_coo(rows, cols, vals, (n, n))


def random_sparse(n: int, density: float = 0.1, dominance: bool = True, seed: int = 0) -> Matrix:
    rng = np.random.default_rng(seed)
    rows, cols, vals = _sparse_offdiag(n, density, rng)
    row_sums = np.zeros(n)
    np.add.at(row_sums, rows, np.abs(vals))
    diag = row_sums * 1.5 + 1.0 if dominance else rng.uniform(1.0, 6.0, size=n)
    d = np.arange(n)
    rows = np.concatenate([rows, d])
    cols = np.concatenate([cols, d])
    vals = np.concatenate([vals, diag])
    return Matrix.from_coo(rows, cols, vals, (n, n))


def tridiagonal(n: int, off_diagonal: float = -1.0) -> Matrix:
    d = np.arange(n)
    rows = np.concatenate([d, d[1:], d[:-1]])
    cols = np.concatenate([d, d[1:] - 1, d[:-1] + 1])
    vals = np.concatenate(
        [np.full(n, 2.0), np.full(n - 1, off_diagonal), np.full(n - 1, off_diagonal)]
    )
    return Matrix.from_coo(rows, cols, vals, (n, n))


def symmetric_laplacian_graph(n: int, connectivity: float = 0.05, seed: int = 0) -> Matrix:
    """Symmetric graph Laplacian (undirected) — used by effective-resistance
    and community workloads (reference: scripts/social_networks fixtures)."""
    rng = np.random.default_rng(seed)
    rows, cols, _ = _sparse_offdiag(n, connectivity / 2, rng)
    mask = rows < cols
    rows, cols = rows[mask], cols[mask]
    r = np.concatenate([rows, cols])
    c = np.concatenate([cols, rows])
    v = -np.ones(r.size)
    degree = np.zeros(n)
    np.add.at(degree, r, 1.0)
    d = np.arange(n)
    return Matrix.from_coo(
        np.concatenate([r, d]), np.concatenate([c, d]), np.concatenate([v, degree]), (n, n)
    )


CATALOG_KINDS = (
    "dd_symmetric",
    "dd_asymmetric",
    "tridiagonal",
    "spd_well",
    "spd_ill",
    "banded",
    "sparse_dd",
    "laplacian_1d",
)


def catalog_matrix(kind: str, n: int, seed: int = 0) -> Matrix:
    """Canonical fixture matrices mirroring the reference's test-matrix
    catalog (scripts/linear_systems/test_matrices: 8 types
    x n in {50,100,200,500}, indexed by matrix_catalog.json)."""
    rng = np.random.default_rng(seed + hash(kind) % 10_000)
    if kind == "dd_symmetric":
        rows, cols, vals = _sparse_offdiag(n, 0.1, rng)
        mask = rows < cols
        r = np.concatenate([rows[mask], cols[mask]])
        c = np.concatenate([cols[mask], rows[mask]])
        v = np.concatenate([vals[mask], vals[mask]])
        s = np.zeros(n)
        np.add.at(s, r, np.abs(v))
        d = np.arange(n)
        return Matrix.from_coo(
            np.concatenate([r, d]), np.concatenate([c, d]),
            np.concatenate([v, 1.5 * s + 1.0]), (n, n),
        )
    if kind == "dd_asymmetric":
        return random_sparse(n, density=0.1, dominance=True, seed=seed)
    if kind == "tridiagonal" or kind == "laplacian_1d":
        return tridiagonal(n)
    if kind == "spd_well":
        # B B^T + n I: SPD with modest condition number
        B = rng.normal(size=(n, max(n // 4, 2)))
        return Matrix.from_dense(B @ B.T / n + np.eye(n))
    if kind == "spd_ill":
        # SPD with geometric eigenvalue spread ~1e6
        d = np.logspace(0, 6, n)
        Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
        return Matrix.from_dense(Q @ np.diag(d) @ Q.T)
    if kind == "banded":
        band = 3
        rows, cols, vals = [], [], []
        for off in range(1, band + 1):
            idx = np.arange(n - off)
            w = rng.uniform(-1, 1, size=n - off)
            rows += [idx, idx + off]
            cols += [idx + off, idx]
            vals += [w, w]
        rows = np.concatenate(rows)
        cols = np.concatenate(cols)
        vals = np.concatenate(vals)
        s = np.zeros(n)
        np.add.at(s, rows, np.abs(vals))
        d = np.arange(n)
        return Matrix.from_coo(
            np.concatenate([rows, d]), np.concatenate([cols, d]),
            np.concatenate([vals, 1.2 * s + 1.0]), (n, n),
        )
    if kind == "sparse_dd":
        return random_sparse(n, density=min(10.0 / n, 0.5), dominance=True, seed=seed)
    raise InvalidParametersError(f"Unknown catalog kind: {kind}")


def catalog(sizes=(50, 100, 200, 500), kinds=CATALOG_KINDS, seed: int = 0) -> dict:
    """Full fixture catalog {kind: {n: Matrix}}."""
    return {kind: {n: catalog_matrix(kind, n, seed) for n in sizes} for kind in kinds}


def rhs(n: int, seed: int = 0, kind: str = "uniform") -> np.ndarray:
    rng = np.random.default_rng(seed + 7919)
    if kind == "ones":
        return np.ones(n)
    if kind == "unit":
        b = np.zeros(n)
        b[0] = 1.0
        return b
    return rng.uniform(-1.0, 1.0, size=n)
