"""Slot-major ELL + COO-tail and dense device operators, and vector
helpers, as in ``sublinear_tpu/formats/ell.py``.

ELL is the route for sparse matrices that are neither banded nor taken by
the sparse kernel (``"csr"``) and too large for the dense route
(n > ``DENSE_THRESHOLD``); dense is the n <= ``DENSE_THRESHOLD`` route.  The
JAX package pads every domain to a multiple of 128 lanes for the TPU's
tiling; the port needs no padding, so ``n_pad == n`` and ``m_pad == m``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_dtype, to_device
from ..ops import spmv
from .csr import CSR


class EllOperator:
    """Slot-major ELL + COO-tail sparse operator."""

    def __init__(self, values, cols, tail_vals, tail_rows, tail_cols, diag,
                 inv_diag, *, shape):
        self.values = values        # (K, n)
        self.cols = cols            # (K, n) int32 into the column domain
        self.tail_vals = tail_vals  # (T,)
        self.tail_rows = tail_rows  # (T,) int32, sorted ascending
        self.tail_cols = tail_cols  # (T,) int32
        self.diag = diag            # (n,)
        self.inv_diag = inv_diag    # (n,), 0 where diag == 0
        self.shape = shape
        self.n_pad, self.m_pad = shape

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def slot_count(self) -> int:
        return int(self.values.shape[0])

    @property
    def tail_nnz(self) -> int:
        return int(self.tail_vals.shape[0])

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        y = spmv.ell_matvec(self.values, self.cols, x)
        if self.tail_nnz:
            y = y + spmv.coo_matvec(self.tail_vals, self.tail_rows,
                                    self.tail_cols, x, self.n_pad)
        return y

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        Y = spmv.ell_matmat(self.values, self.cols, X)
        if self.tail_nnz:
            Y = Y + spmv.coo_matmat(self.tail_vals, self.tail_rows,
                                    self.tail_cols, X, self.n_pad)
        return Y

    def offdiag_matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.matvec(x) - self.diag * x


class DenseOperator:
    """Dense operator: A held as an (n, m) tensor, products via matmul."""

    def __init__(self, data, diag, inv_diag, *, shape, n_pad, m_pad):
        self.data = data          # (n_pad, m_pad)
        self.diag = diag          # (n_pad,)
        self.inv_diag = inv_diag  # (n_pad,)
        self.shape = shape
        self.n_pad = n_pad
        self.m_pad = m_pad

    @property
    def dtype(self):
        return self.data.dtype

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return spmv.dense_matvec(self.data, x)

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        return spmv.dense_matmat(self.data, X)

    def offdiag_matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.matvec(x) - self.diag * x


def _diag_arrays(csr: CSR, n_pad: int, dtype, device):
    """(diag, inv_diag) as host f64 arithmetic cast to ``dtype``; 0 where
    the diagonal is 0 (same values as the JAX package's helper)."""
    diag = np.zeros(n_pad, dtype=np.float64)
    diag[: min(csr.shape)] = csr.diagonal_vector()
    inv = np.where(diag != 0.0, 1.0 / np.where(diag == 0.0, 1.0, diag), 0.0)
    return to_device(diag, dtype, device), to_device(inv, dtype, device)


def choose_slot_cap(row_nnz: np.ndarray) -> int:
    """ELL slot cap minimizing K*n + 3*tail(K) over K via degree-histogram
    suffix sums: the JAX package's cost model (a slot costs one gather per
    row whether it is padding or not, a COO-tail entry about three slots),
    copied so that both packages cut a matrix at the same K."""
    if row_nnz.size == 0:
        return 1
    mx = int(row_nnz.max())
    if mx <= 1:
        return max(mx, 1)
    hist = np.bincount(row_nnz.astype(np.int64), minlength=mx + 1).astype(np.int64)
    d = np.arange(mx + 1, dtype=np.int64)
    # suffix sums: S1[k] = #rows with deg >= k, S2[k] = sum of their degs
    s1 = np.cumsum(hist[::-1])[::-1]
    s2 = np.cumsum((d * hist)[::-1])[::-1]
    ks = np.arange(1, mx + 1)
    # tail(K) = sum_{d>K} (d-K)*hist[d] = S2[K+1] - K*S1[K+1]
    s1p = np.append(s1, 0)[ks + 1]
    s2p = np.append(s2, 0)[ks + 1]
    tail = s2p - ks * s1p
    cost = ks * int(row_nnz.size) + 3 * tail
    return int(ks[np.argmin(cost)])


def ell_from_csr(csr: CSR, dtype=None, device=None,
                 slot_cap: int | None = None) -> EllOperator:
    """The first K entries of each row (CSR order) go to the slots, the rest
    to the COO tail; K is ``slot_cap`` or ``choose_slot_cap``."""
    dtype = resolve_dtype(dtype)
    n, m = csr.shape
    K = slot_cap if slot_cap is not None else choose_slot_cap(csr.row_nnz())
    K = max(int(K), 1)

    rows = csr.row_of_entry()
    pos = np.arange(csr.nnz, dtype=np.int64) - csr.indptr[rows]
    in_ell = pos < K

    values = np.zeros((K, n), dtype=np.float64)
    cols = np.zeros((K, n), dtype=np.int32)
    values[pos[in_ell], rows[in_ell]] = csr.data[in_ell]
    cols[pos[in_ell], rows[in_ell]] = csr.indices[in_ell]

    i32 = torch.int32
    diag, inv_diag = _diag_arrays(csr, n, dtype, device)
    return EllOperator(
        to_device(values, dtype, device), to_device(cols, i32, device),
        to_device(csr.data[~in_ell], dtype, device),
        to_device(rows[~in_ell], i32, device),  # CSR order: sorted by row
        to_device(csr.indices[~in_ell], i32, device),
        diag, inv_diag, shape=(n, m))


def dense_from_csr(csr: CSR, dtype=None, device=None) -> DenseOperator:
    dtype = resolve_dtype(dtype)
    n, m = csr.shape
    data = to_device(csr.to_dense(), dtype, device)
    diag, inv_diag = _diag_arrays(csr, n, dtype, device)
    return DenseOperator(data, diag, inv_diag, shape=(n, m), n_pad=n, m_pad=m)


def pad_vector(v, n_pad: int, dtype=None, device=None) -> torch.Tensor:
    dtype = resolve_dtype(dtype)
    v = np.asarray(v, dtype=np.float64).reshape(-1)
    out = np.zeros(n_pad, dtype=np.float64)
    out[: v.size] = v
    return to_device(out, dtype, device)
