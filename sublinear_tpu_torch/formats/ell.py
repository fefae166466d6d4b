"""Dense device operator and vector helpers, as in
``sublinear_tpu/formats/ell.py``.

This is the n <= ``DENSE_THRESHOLD`` route.  The JAX package pads every
domain to a multiple of 128 lanes for the TPU's tiling; the port needs no
padding, so ``n_pad == n`` and ``m_pad == m``.  ``EllOperator`` is still to
be ported (ROADMAP queue 1, item 2).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_dtype, to_device
from ..ops import spmv
from .csr import CSR


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
