"""DIA (diagonal-storage) eligibility, as in ``sublinear_tpu/formats/dia.py``.

Only the host predicate is ported so far, so the router in ``matrix.py``
keeps the JAX package's predicate order (DIA -> sparse kernel -> dense/ELL).
The ``DiaOperator`` itself is still to be ported (ROADMAP queue 1, item 2).
"""
from __future__ import annotations

import numpy as np

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
