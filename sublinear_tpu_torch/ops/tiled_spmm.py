"""Tiled one-hot SpMM, as in ``sublinear_tpu/ops/pallas_spmv.py``.

The JAX package's ``onehot_spmm`` computes Y = A X over (row-block,
col-block) tiles of T entries (``build_tiles``), routing the gather of X's
rows and the scatter into Y's rows through the TPU's matrix unit as one-hot
matmuls, in bf16 passes.  The tiles and the one-hot matmuls exist because
the TPU has no fast gather; Hopper has one.  So the port keeps the API and
the arithmetic, not the schedule:

- ``build_tiles`` returns the same tile arrays, bit for bit (as torch tensors
  on the port's device), plus ``csr``: a row-sorted int32 CSR view of the
  input's own entries (explicit zeros included, the tiles' val-0 pad slots
  not), with rows padded to ``n_pad``;
- ``onehot_spmm`` launches the ``csr_spmm`` kernel (``ops/csr_spmv.py``) on
  that view in mode ``"split"`` (``precise=True``: v and x split into bf16
  halves, three products, the sum split again) or ``"bf16"``
  (``precise=False``), the per-entry arithmetic of ``_spmm_kernel``.  Only
  the order of each row's f32 sum differs.

``onehot_spmm_plain`` is the plain PyTorch version; a CPU tensor takes it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import host_float, to_device
from ..formats.csr import CSR
from .csr_spmv import CsrOperator, csr_spmm, csr_spmm_plain

TILE_R = 1024
TILE_C = 1024
TILE_T = 512  # entries per tile; any multiple of 128

_INT32_LIMIT = 2**31


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class OneHotTiles:
    vals: torch.Tensor        # (n_tiles, 1, T) f32
    lrow: torch.Tensor        # (n_tiles, 1, T) i32 in [0, R)
    lcol: torch.Tensor        # (n_tiles, 1, T) i32 in [0, C)
    tile_rb: torch.Tensor     # (n_tiles,) i32
    tile_cb: torch.Tensor     # (n_tiles,) i32
    tile_first: torch.Tensor  # (n_tiles,) i32: 1 when first tile of its rb
    n_pad: int                # rows padded to multiple of R
    m_pad: int                # cols padded to multiple of C
    shape: tuple
    csr: CsrOperator          # the entries as a row-sorted CSR, n_pad rows
    R: int = TILE_R
    C: int = TILE_C
    T: int = TILE_T

    @property
    def n_tiles(self) -> int:
        return int(self.vals.shape[0])

    @property
    def fill(self) -> float:
        return (int(host_float(torch.count_nonzero(self.vals)))
                / max(self.vals.numel(), 1))


def pack_tiles(tvals, tlrow, tlcol, t_rb, t_cb, first, rows, cols, vals, *,
               n_pad, m_pad, shape, R, C, T, device=None) -> OneHotTiles:
    """OneHotTiles from host arrays: the tile arrays ((n_tiles, T) vals,
    lrow, lcol; (n_tiles,) rb, cb, first) and the entries (rows, cols,
    vals) of the CSR view, which must be sorted by row."""
    rows = np.asarray(rows, dtype=np.int64)
    if rows.size >= _INT32_LIMIT:
        raise ValueError(f"{rows.size} entries do not fit int32 CSR indices")
    indptr = np.zeros(n_pad + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n_pad), out=indptr[1:])
    i32, f32 = torch.int32, torch.float32
    view = CsrOperator(
        to_device(indptr, i32, device), to_device(cols, i32, device),
        to_device(vals, f32, device), None, None, shape=(n_pad, m_pad),
        nnz=int(rows.size), diag_split=False)
    return OneHotTiles(
        vals=to_device(np.asarray(tvals)[:, None, :], f32, device),
        lrow=to_device(np.asarray(tlrow)[:, None, :], i32, device),
        lcol=to_device(np.asarray(tlcol)[:, None, :], i32, device),
        tile_rb=to_device(t_rb, i32, device),
        tile_cb=to_device(t_cb, i32, device),
        tile_first=to_device(first, i32, device),
        n_pad=n_pad, m_pad=m_pad, shape=tuple(shape), csr=view, R=R, C=C,
        T=T)


def build_tiles(csr: CSR, R: int = TILE_R, C: int = TILE_C, T: int = TILE_T,
                device=None) -> OneHotTiles:
    """The JAX package's ``build_tiles`` (same arrays), plus the CSR view."""
    n, m = csr.shape
    n_pad = round_up(max(n, 1), R)
    m_pad = round_up(max(m, 1), C)
    rows = csr.row_of_entry()
    cols = csr.indices.astype(np.int64)
    vals = csr.data

    rb = rows // R
    cb = cols // C
    order = np.lexsort((cb, rb))
    rows_s, cols_s, vals_s = rows[order], cols[order], vals[order]
    rb, cb = rb[order], cb[order]

    # tile boundaries: new tile when (rb, cb) changes or T entries reached
    key = rb * (m_pad // C) + cb
    new_block = np.empty(key.size, dtype=bool)
    if key.size:
        new_block[0] = True
        new_block[1:] = key[1:] != key[:-1]
    block_start = np.maximum.accumulate(np.where(new_block, np.arange(key.size), 0))
    pos_in_block = np.arange(key.size) - block_start
    tile_of_entry_in_block = pos_in_block // T
    tile_key = key * 100_000 + tile_of_entry_in_block
    uniq, tile_idx = np.unique(tile_key, return_inverse=True)
    n_tiles = max(uniq.size, 1)
    slot = pos_in_block % T

    tvals = np.zeros((n_tiles, T), dtype=np.float64)
    tlrow = np.zeros((n_tiles, T), dtype=np.int32)
    tlcol = np.zeros((n_tiles, T), dtype=np.int32)
    tvals[tile_idx, slot] = vals_s
    tlrow[tile_idx, slot] = (rows_s % R).astype(np.int32)
    tlcol[tile_idx, slot] = (cols_s % C).astype(np.int32)

    t_rb = np.zeros(n_tiles, dtype=np.int32)
    t_cb = np.zeros(n_tiles, dtype=np.int32)
    t_rb[tile_idx] = rb.astype(np.int32)
    t_cb[tile_idx] = cb.astype(np.int32)
    # tiles from np.unique are sorted by tile_key (rb-major)
    first = np.empty(n_tiles, dtype=np.int32)
    first[0] = 1
    first[1:] = (t_rb[1:] != t_rb[:-1]).astype(np.int32)

    # the CSR view: the input's entries in its own (row-sorted) order
    return pack_tiles(tvals, tlrow, tlcol, t_rb, t_cb, first, rows,
                      csr.indices, vals, n_pad=n_pad, m_pad=m_pad,
                      shape=(n, m), R=R, C=C, T=T, device=device)


def _mode(precise: bool) -> str:
    return "split" if precise else "bf16"


def onehot_spmm(tiles: OneHotTiles, X: torch.Tensor,
                precise: bool = True) -> torch.Tensor:
    """Y = A @ X with X: (m_pad, B) f32.  Returns (n_pad, B).

    ``precise=True`` (default) is the split-precision product (about 16
    bits of each entry's product kept, ~1e-5 relative); False is the single
    bf16 pass (~3e-3)."""
    return csr_spmm(tiles.csr, X, None, _mode(precise))


def onehot_spmm_plain(tiles: OneHotTiles, X: torch.Tensor,
                      precise: bool = True) -> torch.Tensor:
    """``onehot_spmm`` in plain PyTorch."""
    return csr_spmm_plain(tiles.csr, X, None, _mode(precise))
