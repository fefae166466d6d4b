"""Streaming (larger-than-device) matrix products and device-memory
budgeting, as in ``sublinear_tpu/formats/streaming.py``.

Memory policy: every operator build estimates its device bytes
(``estimate_op_bytes``); a build above ``memory_budget_bytes()`` raises
MemoryLimitError (E007) before allocating.  The budget is 80% of the card's
memory (``torch.cuda.mem_get_info``), overridable with
SLT_MEMORY_LIMIT_BYTES.

``StreamingOperator`` is the way past that budget: the matrix is cut into
row panels sized to ``panel_budget`` bytes by the JAX package's rule and
kept in host memory (pinned when the device is a card), each panel a CSR of
its rows by all m columns.  A product uploads one panel at a time into one
device slot and runs it through ``csr_spmv`` (a ``CsrOperator`` of the
panel, the diagonal not split out), so the device holds one panel plus x
and y whatever the matrix's size.  The JAX package keeps slot-major ELL
panels because the TPU has no fast gather; the CSR panel is what the card's
kernel takes.  ``solve_streaming`` is the JAX package's host Neumann loop
over it.
"""
from __future__ import annotations

import os

import time

import numpy as np
import torch

from ..config import device as resolve_device, to_device
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


class StreamingOperator:
    """Row-panel streamed operator: host-resident CSR panels, products on
    the device one panel at a time.  ``matvec`` and ``offdiag_matvec`` take
    and return host numpy vectors (float64), as the JAX package's do."""

    def __init__(self, csr: CSR, panel_budget: int = 256 * 1024 * 1024,
                 dtype=None, device=None):
        from ..ops.csr_spmv import CsrOperator

        self.shape = csr.shape
        n, m = csr.shape
        self.m_pad = m
        self.dtype = torch.float32  # the panels' values, as in the JAX package
        self.device = resolve_device(device)
        diag = np.zeros(n)
        dv = csr.diagonal_vector()
        diag[: len(dv)] = dv
        self.diag = diag
        self.inv_diag = np.where(diag != 0,
                                 1.0 / np.where(diag == 0, 1.0, diag), 0.0)

        row_nnz = csr.row_nnz()
        K = max(int(row_nnz.max()) if row_nnz.size else 1, 1)
        # panel rows sized so one panel's ELL (vals+cols, 8 B/slot) fits the
        # panel budget: the JAX package's rule, so the panels are the same
        rows_per_panel = max(128, int(panel_budget // max(K * 8, 1)) // 128 * 128)
        on_card = self.device.type == "cuda"
        host = []
        for r0 in range(0, n, rows_per_panel):
            r1 = min(r0 + rows_per_panel, n)
            lo, hi = int(csr.indptr[r0]), int(csr.indptr[r1])
            arrays = [torch.from_numpy(np.ascontiguousarray(a, dtype=dt))
                      for a, dt in ((csr.indptr[r0: r1 + 1] - lo, np.int32),
                                    (csr.indices[lo:hi], np.int32),
                                    (csr.data[lo:hi], np.float32))]
            host.append((r0, r1 - r0, [a.pin_memory() if on_card else a
                                       for a in arrays]))
        self._host = host
        if on_card:
            # one device slot of the largest panel's size; each panel's
            # operator views its front
            rows_max = max(rows for _, rows, _ in host)
            nnz_max = max(max(a[1].numel() for _, _, a in host), 1)
            self._slot = (
                torch.empty(rows_max + 1, dtype=torch.int32, device=self.device),
                torch.empty(nnz_max, dtype=torch.int32, device=self.device),
                torch.empty(nnz_max, dtype=torch.float32, device=self.device))
        self.panels = []
        for r0, rows, (indptr, indices, vals) in host:
            nnz = indices.numel()
            if on_card:
                indptr, indices, vals = (self._slot[0][: rows + 1],
                                         self._slot[1][:nnz],
                                         self._slot[2][:nnz])
            self.panels.append((r0, rows, CsrOperator(
                indptr, indices, vals, None, None, shape=(rows, m), nnz=nnz,
                diag_split=False)))

    @property
    def n_panels(self) -> int:
        return len(self.panels)

    def matvec_device(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x for an f32 x (m,) on the device, as an f32 tensor there:
        each panel is uploaded into the slot, then multiplied."""
        from ..ops.csr_spmv import csr_spmv

        y = torch.empty(self.shape[0], dtype=torch.float32, device=x.device)
        for (r0, rows, op), (_, _, arrays) in zip(self.panels, self._host):
            if x.is_cuda:
                for dst, src in zip((op.indptr, op.indices, op.vals), arrays):
                    dst.copy_(src, non_blocking=True)
            y[r0: r0 + rows] = csr_spmv(op, x)
        return y

    def matvec(self, x: np.ndarray) -> np.ndarray:
        """y = A @ x streaming one panel at a time through the device."""
        m = self.shape[1]
        x_dev = to_device(np.asarray(x, dtype=np.float64)[:m], torch.float32,
                          self.device)
        return self.matvec_device(x_dev).cpu().numpy().astype(np.float64)

    def offdiag_matvec(self, x: np.ndarray) -> np.ndarray:
        return (self.matvec(x)
                - self.diag * np.asarray(x, dtype=np.float64)[: self.shape[0]])


def solve_streaming(matrix, b, options=None, raise_on_fail: bool = True,
                    panel_budget: int = 256 * 1024 * 1024):
    """Host-driven Neumann solve over a StreamingOperator: converges for DD
    systems of any size that fits host RAM.  ``panel_budget`` sizes the
    panels (the JAX package's fixed default)."""
    from ..solvers import base
    from ..types import SolverOptions, SolverResult

    options = options or SolverOptions()
    op = StreamingOperator(matrix.csr, panel_budget, dtype=options.dtype,
                           device=matrix.device)
    b64 = np.asarray(b, dtype=np.float64)
    threshold = base.threshold_for(b64, options)
    t0 = time.perf_counter()
    term = op.inv_diag * b64
    x = term.copy()
    res = float("inf")
    k = 0
    check = max(options.check_every, 1)
    while k < options.max_iterations:
        for _ in range(check):
            term = -op.inv_diag * (op.matvec(term) - op.diag * term)
            x = x + term
            k += 1
        res = float(np.linalg.norm(op.matvec(x) - b64))
        if not np.isfinite(res) or res <= threshold:
            break
    result = SolverResult(
        solution=x, iterations=k, residual=res,
        converged=bool(np.isfinite(res) and res <= threshold * 1.0000001),
        method="neumann-streaming",
        compute_time_ms=(time.perf_counter() - t0) * 1e3,
    )
    return base.check_outcome(result, threshold, options, raise_on_fail)
