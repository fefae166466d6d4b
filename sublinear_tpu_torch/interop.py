"""Carry state across from the JAX package.

The matrix is this system's only state: ``matrix_from_reference`` takes the
JAX package's host CSR as NumPy arrays (``A.csr.indptr``, ``A.csr.indices``,
``A.csr.data``) and builds the port's ``Matrix`` on a torch device, so both
packages solve the same system.
"""
from __future__ import annotations

import numpy as np

from .formats.csr import CSR
from .matrix import Matrix


def matrix_from_reference(indptr, indices, data, shape, device=None,
                          prefer=None) -> Matrix:
    return Matrix(CSR(np.asarray(indptr), np.asarray(indices),
                      np.asarray(data), shape),
                  prefer=prefer, device=device)
