"""Dense products, as in ``sublinear_tpu/ops/spmv.py::dense_matvec/matmat``.

The JAX package computes these with ``jnp.dot`` at ``Precision.HIGHEST``
outside any Pallas kernel; here they are ``torch.matmul`` in full float32
(``config`` turns TF32 off).  The ELL/COO products are still to be ported
(ROADMAP queue 1, item 2); the sparse single-RHS product lives in
``ops/csr_spmv.py``.
"""
from __future__ import annotations

import torch


def dense_matvec(data: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(data, x)


def dense_matmat(data: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    return torch.matmul(data, X)
