"""Device-memory budgeting, as in ``sublinear_tpu/formats/streaming.py``.

Every operator build estimates its device bytes (``estimate_op_bytes``); a
build above ``memory_budget_bytes()`` raises MemoryLimitError (E007) before
allocating.  The budget is 80% of the card's memory
(``torch.cuda.mem_get_info``), overridable with SLT_MEMORY_LIMIT_BYTES.
The ``StreamingOperator`` and ``solve_streaming`` are still to be ported
(ROADMAP queue 1, item 5).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..errors import MemoryLimitError
from .csr import CSR

_DEFAULT_BUDGET = 12 * 1024**3  # host-memory budget when no card is used


def memory_budget_bytes(device=None) -> int:
    env = os.environ.get("SLT_MEMORY_LIMIT_BYTES")
    if env:
        return int(env)
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        _, total = torch.cuda.mem_get_info(dev)
        return int(total * 0.8)
    return _DEFAULT_BUDGET


def estimate_op_bytes(csr: CSR, kind: str) -> int:
    """Device bytes a packed operator of ``kind`` would occupy in the port's
    unpadded layouts (f32 values, i32 indices, diag + inv_diag vectors)."""
    n, m = csr.shape
    vec = 2 * max(n, 1) * 4  # diag + inv_diag
    if kind == "dense":
        return n * m * 4 + vec
    if kind == "csr":
        return 8 * csr.nnz + 4 * (n + 1) + vec
    if kind == "dia":
        from .dia import dia_offsets

        offs = dia_offsets(csr)
        return (len(offs) if offs is not None else 1) * n * 4 + vec
    if kind == "ell":
        from .ell import choose_slot_cap

        row_nnz = csr.row_nnz()
        K = max(choose_slot_cap(row_nnz), 1)
        tail = int(np.maximum(row_nnz - K, 0).sum())
        # K slots of (f32 value, i32 column) per row; tail (value, row, col)
        return K * n * 8 + tail * 12 + vec
    raise ValueError(f"no device-byte estimate for operator kind {kind!r}")


def check_memory_budget(csr: CSR, kind: str, budget: int | None = None,
                        device=None) -> int:
    need = estimate_op_bytes(csr, kind)
    limit = budget if budget is not None else memory_budget_bytes(device)
    if need > limit:
        raise MemoryLimitError(
            f"packed '{kind}' operator needs ~{need/1e9:.2f} GB > device "
            f"budget {limit/1e9:.2f} GB; raise SLT_MEMORY_LIMIT_BYTES",
            {"requiredBytes": need, "budgetBytes": limit, "kind": kind},
        )
    return need
