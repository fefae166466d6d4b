"""Host-side CSR construction and manipulation (NumPy).

A copy of ``sublinear_tpu/formats/csr.py`` without the native C++ packer:
``CSR.from_coo`` always takes the NumPy path, which yields the same arrays
(rows sorted, columns sorted within a row, duplicates summed).  The parity
tests hold the two packages' CSR arrays bit-identical.
"""
from __future__ import annotations

import numpy as np

from ..errors import DimensionMismatchError, InvalidMatrixError


class CSR:
    """Minimal host CSR: indptr (n+1,), indices (nnz,), data (nnz,)."""

    __slots__ = ("indptr", "indices", "data", "shape")

    def __init__(self, indptr, indices, data, shape):
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.indices = np.asarray(indices, dtype=np.int32)
        self.data = np.asarray(data, dtype=np.float64)
        self.shape = (int(shape[0]), int(shape[1]))
        if self.indptr.shape[0] != self.shape[0] + 1:
            raise InvalidMatrixError(
                f"indptr length {self.indptr.shape[0]} != rows+1 {self.shape[0] + 1}"
            )

    # ------------------------------------------------------------------ build
    @classmethod
    def from_coo(cls, rows, cols, vals, shape, sum_duplicates: bool = True) -> "CSR":
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals, dtype=np.float64)
        n, m = int(shape[0]), int(shape[1])
        if rows.size:
            if rows.min() < 0 or rows.max() >= n or cols.min() < 0 or cols.max() >= m:
                raise InvalidMatrixError("COO indices out of bounds")
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        if sum_duplicates and rows.size:
            # collapse duplicate (i,j) pairs by summation
            keys = rows * m + cols
            uniq, inv = np.unique(keys, return_inverse=True)
            if uniq.size != keys.size:
                summed = np.zeros(uniq.size, dtype=np.float64)
                np.add.at(summed, inv, vals)
                rows, cols, vals = uniq // m, uniq % m, summed
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, rows + 1, 1)
        np.cumsum(indptr, out=indptr)
        return cls(indptr, cols.astype(np.int32), vals, (n, m))

    @classmethod
    def from_dense(cls, dense, tol: float = 0.0) -> "CSR":
        dense = np.asarray(dense, dtype=np.float64)
        if dense.ndim != 2:
            raise InvalidMatrixError("dense matrix must be 2-D")
        mask = np.abs(dense) > tol
        rows, cols = np.nonzero(mask)
        return cls.from_coo(rows, cols, dense[rows, cols], dense.shape, sum_duplicates=False)

    @classmethod
    def identity(cls, n: int) -> "CSR":
        idx = np.arange(n)
        return cls.from_coo(idx, idx, np.ones(n), (n, n), sum_duplicates=False)

    @classmethod
    def diagonal(cls, d) -> "CSR":
        d = np.asarray(d, dtype=np.float64)
        idx = np.arange(d.size)
        return cls.from_coo(idx, idx, d, (d.size, d.size), sum_duplicates=False)

    # ------------------------------------------------------------------ props
    @property
    def nnz(self) -> int:
        return int(self.data.size)

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr)

    def row_of_entry(self) -> np.ndarray:
        """Row index for each stored entry (length nnz)."""
        return np.repeat(
            np.arange(self.shape[0], dtype=np.int64), np.diff(self.indptr)
        )

    def diagonal_vector(self) -> np.ndarray:
        n = min(self.shape)
        diag = np.zeros(n, dtype=np.float64)
        rows = self.row_of_entry()
        mask = (rows < n) & (self.indices == rows)
        np.add.at(diag, rows[mask], self.data[mask])
        return diag

    # ------------------------------------------------------------------ ops
    def matvec(self, x) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        if x.shape[0] != self.shape[1]:
            raise DimensionMismatchError(
                f"matvec: matrix cols {self.shape[1]} != vector length {x.shape[0]}"
            )
        prod = self.data * x[self.indices]
        out = np.zeros(self.shape[0], dtype=np.float64)
        np.add.at(out, self.row_of_entry(), prod)
        return out

    def transpose(self) -> "CSR":
        rows = self.row_of_entry()
        return CSR.from_coo(
            self.indices.astype(np.int64),
            rows,
            self.data,
            (self.shape[1], self.shape[0]),
            sum_duplicates=False,
        )

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=np.float64)
        out[self.row_of_entry(), self.indices] = self.data
        return out

    def to_coo(self):
        return self.row_of_entry(), self.indices.astype(np.int64), self.data.copy()

    def scale(self, factor: float) -> "CSR":
        return CSR(self.indptr, self.indices, self.data * factor, self.shape)

    def add_diagonal(self, shift: float) -> "CSR":
        r, c, v = self.to_coo()
        n = min(self.shape)
        idx = np.arange(n)
        return CSR.from_coo(
            np.concatenate([r, idx]),
            np.concatenate([c, idx]),
            np.concatenate([v, np.full(n, shift)]),
            self.shape,
        )

    # ------------------------------------------------------------- analysis
    def offdiag_abs_row_sums(self) -> np.ndarray:
        rows = self.row_of_entry()
        off = self.indices != rows
        sums = np.zeros(self.shape[0], dtype=np.float64)
        np.add.at(sums, rows[off], np.abs(self.data[off]))
        return sums

    def offdiag_abs_col_sums(self) -> np.ndarray:
        rows = self.row_of_entry()
        off = self.indices != rows
        sums = np.zeros(self.shape[1], dtype=np.float64)
        np.add.at(sums, self.indices[off], np.abs(self.data[off]))
        return sums

    def bandwidth(self) -> int:
        if self.nnz == 0:
            return 0
        return int(np.max(np.abs(self.row_of_entry() - self.indices)))

    def is_symmetric(self, rtol: float = 1e-10) -> bool:
        if self.shape[0] != self.shape[1]:
            return False
        t = self.transpose()
        if t.nnz != self.nnz:
            # structural asymmetry can still be numerically symmetric w/ zeros
            pass
        a = self.to_coo()
        b = t.to_coo()
        if a[0].size != b[0].size:
            return False
        if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
            return False
        scale = max(1.0, float(np.max(np.abs(a[2]))) if a[2].size else 1.0)
        return bool(np.allclose(a[2], b[2], atol=rtol * scale))
