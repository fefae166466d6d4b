"""DIA (diagonal-storage) operator, as in ``sublinear_tpu/formats/dia.py``.

For a banded matrix every nonzero lies on one of a few diagonals.  Stored as
``(D, n)`` diagonal vectors, a product is D shifted multiply-adds over a
zero-padded ``x``:

    y[i] = sum_d data[d, i] * x[i + offset_d]

with no gather.  The JAX package writes these in plain ``jnp`` (no Pallas
kernel); here they are plain PyTorch.  The router in ``matrix.py`` keeps the
JAX package's predicate order (DIA -> sparse kernel -> dense/ELL).  The
domain is not padded: ``n_pad == m_pad == n``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import resolve_dtype, to_device
from .csr import CSR

# An exact DIA representation must cover every distinct offset.
MAX_DIAGS = 128


def dia_offsets(csr: CSR) -> np.ndarray | None:
    """Distinct nonzero offsets (col - row), or None if the matrix is not
    *usefully* diagonal-representable: square, at most MAX_DIAGS offsets,
    and genuinely banded (D small relative to n and diagonals reasonably
    full)."""
    n = csr.shape[0]
    if n != csr.shape[1] or csr.nnz == 0:
        return None
    rows = csr.row_of_entry()
    offs = csr.indices.astype(np.int64) - rows.astype(np.int64)
    uniq = np.unique(offs)
    D = uniq.size
    if D > min(MAX_DIAGS, max(n // 4, 3)):
        return None
    if csr.nnz < 0.25 * D * n:  # diagonals must be reasonably full
        return None
    return uniq


class DiaOperator:
    """Shifted-diagonal operator."""

    def __init__(self, data, diag, inv_diag, *, offsets, shape, nnz):
        self.data = data          # (D, n); data[d, i] = A[i, i + offsets[d]]
        self.diag = diag          # (n,)
        self.inv_diag = inv_diag  # (n,), 0 where diag == 0
        self.offsets = offsets    # tuple of python ints, sorted
        self.shape = shape
        self.n_pad = self.m_pad = shape[0]
        self.nnz = nnz            # the source matrix's, not D * n

    @property
    def dtype(self):
        return self.data.dtype

    def _pad_width(self):
        return max(-min(self.offsets), 0), max(max(self.offsets), 0)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi = self._pad_width()
        xp = F.pad(x, (lo, hi))
        y = torch.zeros(self.n_pad, dtype=self.dtype, device=x.device)
        for d, off in enumerate(self.offsets):
            y = y + self.data[d] * xp[lo + off: lo + off + self.n_pad]
        return y

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        lo, hi = self._pad_width()
        Xp = F.pad(X, (0, 0, lo, hi))
        Y = torch.zeros((self.n_pad, X.shape[1]), dtype=self.dtype,
                        device=X.device)
        for d, off in enumerate(self.offsets):
            Y = Y + self.data[d][:, None] * Xp[lo + off: lo + off + self.n_pad]
        return Y

    def offdiag_matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.matvec(x) - self.diag * x


def dia_from_csr(csr: CSR, dtype=None, device=None) -> DiaOperator:
    """Build a DiaOperator; raises ValueError when the matrix is not
    diagonal-representable (use dia_offsets to test first)."""
    from .ell import _diag_arrays

    dt = resolve_dtype(dtype)
    offsets = dia_offsets(csr)
    if offsets is None:
        raise ValueError("matrix is not representable with <= MAX_DIAGS diagonals")
    n = csr.shape[0]
    rows = csr.row_of_entry().astype(np.int64)
    offs = csr.indices.astype(np.int64) - rows
    slot = np.searchsorted(offsets, offs)
    data = np.zeros((len(offsets), n))
    data[slot, rows] = csr.data  # CSR has unique (row, col) entries
    diag, inv_diag = _diag_arrays(csr, n, dt, device)
    return DiaOperator(to_device(data, dt, device), diag, inv_diag,
                       offsets=tuple(int(o) for o in offsets),
                       shape=csr.shape, nnz=csr.nnz)
