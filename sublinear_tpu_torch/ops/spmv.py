"""Sparse and dense products, as in ``sublinear_tpu/ops/spmv.py``.

The JAX package computes these with ``jnp.take``, ``einsum``,
``segment_sum`` and ``jnp.dot`` at ``Precision.HIGHEST``, outside any
Pallas kernel; here they are plain PyTorch in full float32 (``config``
turns TF32 off).  Slot-major ELL: ``values``/``cols`` of shape ``(K, n)``,
padded slots pointing at column 0 with value 0; the COO tail holds the
entries beyond the slot cap, rows sorted.  Not ported, as TPU-gather layout
tricks: ``ell_matvec_wide`` (the 8-column wide gather), the batch-major
``_bmajor`` products and ``solve_batch``'s padding of an ELL batch to at
least 8 columns; the port's ``solve_batch`` runs n-major (X is (n, B)) on
every operator.  The sparse products of the ``"csr"`` route, single-RHS and
batched, live in ``ops/csr_spmv.py``.
"""
from __future__ import annotations

import torch


def ell_matvec(values: torch.Tensor, cols: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for slot-major ELL. values/cols: (K, n); x: (m,)."""
    gathered = x.index_select(0, cols.reshape(-1)).view(cols.shape)
    return (values * gathered).sum(0)


def ell_matmat(values: torch.Tensor, cols: torch.Tensor,
               X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for batched RHS.  X: (m, B) -> (n, B)."""
    gathered = X.index_select(0, cols.reshape(-1)).view(*cols.shape, X.shape[1])
    return (values[:, :, None] * gathered).sum(0)


def coo_matvec(vals: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
               x: torch.Tensor, n: int) -> torch.Tensor:
    """Tail COO product: y[rows] += vals * x[cols]."""
    y = torch.zeros(n, dtype=x.dtype, device=x.device)
    return y.index_add_(0, rows, vals * x.index_select(0, cols))


def coo_matmat(vals: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
               X: torch.Tensor, n: int) -> torch.Tensor:
    Y = torch.zeros((n, X.shape[1]), dtype=X.dtype, device=X.device)
    return Y.index_add_(0, rows, vals[:, None] * X.index_select(0, cols))


def dense_matvec(data: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(data, x)


def dense_matmat(data: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    return torch.matmul(data, X)
