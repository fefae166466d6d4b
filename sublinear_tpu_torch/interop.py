"""Carry state across from the JAX package.

The matrix is this system's only state: ``matrix_from_reference`` takes the
JAX package's host CSR as NumPy arrays (``A.csr.indptr``, ``A.csr.indices``,
``A.csr.data``) and builds the port's ``Matrix`` on a torch device, so both
packages solve the same system.  ``tiles_from_reference`` does the same for
a packed ``OneHotTiles`` of ``sublinear_tpu/ops/pallas_spmv.py``.
"""
from __future__ import annotations

import numpy as np

from .formats.csr import CSR
from .matrix import Matrix
from .ops.tiled_spmm import OneHotTiles, pack_tiles


def matrix_from_reference(indptr, indices, data, shape, device=None,
                          prefer=None) -> Matrix:
    return Matrix(CSR(np.asarray(indptr), np.asarray(indices),
                      np.asarray(data), shape),
                  prefer=prefer, device=device)


def tiles_from_reference(vals, lrow, lcol, tile_rb, tile_cb, tile_first, *,
                         n_pad, m_pad, shape, R, C, T,
                         device=None) -> OneHotTiles:
    """The port's OneHotTiles from a JAX ``OneHotTiles``'s arrays (as NumPy
    arrays) and fields.  The CSR view is rebuilt from the tiles: row
    ``rb * R + lrow``, column ``cb * C + lcol``, the zero-valued slots
    dropped (the tiles' pad slots; an explicit zero entry adds nothing to a
    finite product either)."""
    tvals = np.array(vals, dtype=np.float32).reshape(-1, T)
    tlrow = np.array(lrow, dtype=np.int32).reshape(-1, T)
    tlcol = np.array(lcol, dtype=np.int32).reshape(-1, T)
    t_rb = np.array(tile_rb, dtype=np.int32)
    t_cb = np.array(tile_cb, dtype=np.int32)
    rows = t_rb.astype(np.int64)[:, None] * R + tlrow
    cols = t_cb.astype(np.int64)[:, None] * C + tlcol
    keep = tvals != 0
    rows, cols, data = rows[keep], cols[keep], tvals[keep]
    # stable: within a row, the tiles' (column block, CSR) order is the
    # column order
    order = np.argsort(rows, kind="stable")
    return pack_tiles(tvals, tlrow, tlcol, t_rb, t_cb,
                      np.array(tile_first, dtype=np.int32), rows[order],
                      cols[order], data[order], n_pad=n_pad, m_pad=m_pad,
                      shape=shape, R=R, C=C, T=T, device=device)
