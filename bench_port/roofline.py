"""Peaks of the card and the least bytes of the sparse products a request
needs, after ``chip_smoke.py::bound`` and ``chain_bounds``.

The bytes are counted from the matrix's n and stored entries and from the
iterations the port reports, never from which kernels ran, so a kernel that
is fused, renamed or replaced leaves the count as it is.  Each input byte
is counted once and each output byte once (float32 values and vectors,
int32 indices, as the port stores its CSR).
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, at the full 700 W power limit (a card set
# below it runs slower under load): HBM3 bandwidth and the float32 rate
# outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12}


def spmv_bytes(n: int, nnz: int, columns: int = 1) -> int:
    """One product y = A x over ``columns`` right-hand sides: indptr, the
    column indices and values read once, x read once, y written once."""
    return 4 * (n + 1) + 8 * nnz + 8 * n * columns


def least_seconds(nbytes: float, flops: float = 0.0) -> float:
    """The larger of the bytes over HBM bandwidth and the operations over
    the float32 peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["f32"])


def share_percent(least_s: float, kernel_s: float):
    """The roofline share in %, or None when no kernel time was read."""
    if kernel_s <= 0:
        return None
    return 100.0 * least_s / kernel_s
