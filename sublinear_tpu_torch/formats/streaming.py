"""Device-memory budgeting, as in ``sublinear_tpu/formats/streaming.py``.

Every operator build estimates its device bytes (``estimate_op_bytes``); a
build above ``memory_budget_bytes()`` raises MemoryLimitError (E007) before
allocating.  The budget is 80% of the card's memory
(``torch.cuda.mem_get_info``), overridable with SLT_MEMORY_LIMIT_BYTES.
The ``StreamingOperator`` and ``solve_streaming`` are still to be ported.
"""
from __future__ import annotations

import os

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
    """Device bytes a packed operator of ``kind`` would occupy (f32 values,
    i32 indices, diag + inv_diag vectors)."""
    n, m = csr.shape
    vec = 2 * max(n, 1) * 4  # diag + inv_diag
    if kind == "dense":
        return n * m * 4 + vec
    if kind == "csr":
        return 8 * csr.nnz + 4 * (n + 1) + vec
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
