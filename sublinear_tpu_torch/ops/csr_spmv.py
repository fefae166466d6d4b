"""Diagonal-split CSR operator and its two hand-written CUDA kernels.

``CsrOperator`` is the port's counterpart of
``sublinear_tpu/ops/xbar.py::XbarOperator``.  It keeps that operator's
contract (``matvec``, ``offdiag_matvec``, ``chain_ready``, ``neumann_chain``
with the same outputs) but not its layout: the XBAR route tables, int16
lanes and 16384-row padding exist because the TPU has no fast arbitrary
gather.  Here the off-diagonal entries are a plain CSR (int32 ``indptr`` and
``indices``, f32 values), the diagonal is split out into f32 ``diag`` and
``inv_diag`` of length n, and no domain is padded (``n_pad = m_pad = n``).

Kernels (``csrc/csr_kernels.cu``, built by ``ops/_kernels.py``):
  ``csr_spmv``      y = R x (+ diag * x): replaces ``_fused_call`` and
                    ``_k1_call`` + ``_k2_call``;
  ``neumann_step``  one pass of ``_chain_call``; ``neumann_chain`` launches
                    it ``iters`` times on the current stream.
Each has a plain PyTorch version beside it (``csr_spmv_plain``,
``neumann_chain_plain``).  A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import to_device
from ..formats.csr import CSR

LAUNCHES = {"csr_spmv": 0, "neumann_step": 0}

_INT32_LIMIT = 2**31


class CsrOperator:
    """Off-diagonal CSR + split diagonal, single-RHS operator."""

    def __init__(self, indptr, indices, vals, diag, inv_diag, *, shape, nnz,
                 diag_split):
        self.indptr = indptr      # (n+1,) int32
        self.indices = indices    # (nnz_off,) int32
        self.vals = vals          # (nnz_off,) f32
        self.diag = diag          # (n,) f32
        self.inv_diag = inv_diag  # (n,) f32, 0 where diag == 0
        self.shape = shape
        self.n_pad = shape[0]
        self.m_pad = shape[1]
        self._nnz = nnz
        self.diag_split = diag_split  # diagonal excluded from the CSR
        self._row_ids = None

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device

    @property
    def nnz(self) -> int:
        return self._nnz

    @property
    def tail_nnz(self) -> int:
        return 0

    @property
    def row_ids(self) -> torch.Tensor:
        """Row of each stored entry (int64), for the plain versions."""
        if self._row_ids is None:
            counts = torch.diff(self.indptr.long())
            self._row_ids = torch.repeat_interleave(
                torch.arange(self.n_pad, device=self.device), counts)
        return self._row_ids

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        diag = self.diag if self.diag_split else None
        return csr_spmv(self, x.to(torch.float32), diag).to(x.dtype)

    def offdiag_matvec(self, x: torch.Tensor) -> torch.Tensor:
        if self.diag_split:
            return csr_spmv(self, x.to(torch.float32), None).to(x.dtype)
        return self.matvec(x) - self.diag * x

    @property
    def chain_ready(self) -> bool:
        """True when the Neumann recurrence can run as a chain of
        ``neumann_step`` launches: a square operator with the diagonal split
        out (every square CsrOperator)."""
        return self.diag_split and self.shape[0] == self.shape[1]

    def neumann_chain(self, term0: torch.Tensor, iters: int,
                      with_residual=False):
        """Runs ``iters`` Neumann iterations: returns ``(acc, last_term)``
        with acc = term0 + sum_{j=1..iters} (-D^-1 R)^j term0 and
        last_term = (-D^-1 R)^iters term0.  Seeding with the current term
        mid-series continues the series: the chunked driver uses
        x' = x + (acc - term), term' = last_term.

        With ``with_residual`` a third output comes from the last pass at no
        extra product: res = -R t_{iters-1}, the exact residual of the
        penultimate iterate (for term0 = D^-1 b, b - A x_{iters-1}).
        ``with_residual="norm"`` returns ||res||^2 as a 0-d f32 tensor
        instead.  Outputs have ``term0``'s dtype (the chain runs in f32)."""
        if not self.chain_ready:
            raise ValueError(
                "neumann_chain requires a chain-ready operator (square, "
                f"diagonal split out); this operator has shape={self.shape}, "
                f"diag_split={self.diag_split} - use the per-matvec solver "
                "path")
        dt = term0.dtype
        out = neumann_chain(self, term0.to(torch.float32).contiguous(),
                            int(iters), with_residual)
        acc, term = out[0].to(dt), out[1].to(dt)
        if not with_residual:
            return acc, term
        if with_residual == "norm":
            return acc, term, out[2]
        return acc, term, out[2].to(dt)

    def cg_chain(self, x, r, p, rz, iters: int):
        raise NotImplementedError(
            "cg_chain (ops/xbar.py::_cg_chain_call) is not ported yet; it is "
            "the next kernel in ROADMAP queue 2")


def pack_csr(csr: CSR, device=None) -> CsrOperator:
    """Build a CsrOperator from the host CSR.  For a square matrix the
    diagonal is split out of the CSR, as ``pack_xbar`` splits it out of the
    route tables; ``diag`` and ``inv_diag`` are computed in f32 exactly as
    ``pack_xbar`` computes them."""
    n, m = csr.shape
    rows = csr.row_of_entry()
    split = n == m
    keep = rows != csr.indices if split else np.ones(csr.nnz, dtype=bool)
    kept = int(keep.sum())
    if kept >= _INT32_LIMIT:
        raise ValueError(f"{kept} off-diagonal entries do not fit int32 "
                         "CSR indices")
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows[keep], minlength=n), out=indptr[1:])

    diag = np.zeros(n, dtype=np.float32)
    diag[: min(n, m)] = csr.diagonal_vector().astype(np.float32)
    inv_diag = np.where(diag != 0, 1.0 / np.where(diag == 0, 1.0, diag),
                        0.0).astype(np.float32)

    i32, f32 = torch.int32, torch.float32
    return CsrOperator(
        to_device(indptr, i32, device), to_device(csr.indices[keep], i32, device),
        to_device(csr.data[keep], f32, device), to_device(diag, f32, device),
        to_device(inv_diag, f32, device), shape=(n, m), nnz=csr.nnz,
        diag_split=split)


# ---------------------------------------------------------------- plain

def csr_spmv_plain(op: CsrOperator, x: torch.Tensor, diag=None):
    """y = R x (+ diag * x) with index_select / index_add_."""
    y = torch.zeros(op.n_pad, dtype=x.dtype, device=x.device)
    y.index_add_(0, op.row_ids, op.vals * x.index_select(0, op.indices))
    if diag is not None:
        y = y + diag * x[: op.n_pad]
    return y


def neumann_chain_plain(op: CsrOperator, term0: torch.Tensor, iters: int,
                        with_residual=False):
    """The chain of ``neumann_step`` passes, in plain PyTorch."""
    if iters < 1:
        raise ValueError(f"neumann_chain needs iters >= 1, got {iters}")
    acc, t = term0.clone(), term0
    for _ in range(iters):
        y = csr_spmv_plain(op, t)
        t = -(op.inv_diag * y)
        acc += t
    if with_residual == "norm":
        y64 = y.double()
        return acc, t, torch.dot(y64, y64).to(torch.float32)
    if with_residual:
        return acc, t, -y
    return acc, t


# ---------------------------------------------------------------- kernels

def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _check_operands(op: CsrOperator, **vectors):
    """Raise unless the operator's arrays and the ``name=(tensor, length)``
    vectors are what the kernels take: contiguous 1-D int32 / f32 tensors of
    the right lengths on one CUDA device (None vectors are skipped)."""
    dev = op.vals.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel operands on {dev}")
    nnz = op.indices.numel()
    if nnz >= _INT32_LIMIT:
        raise ValueError("nnz >= 2**31 does not fit the kernels' int32 CSR")
    if op.n_pad < 1:
        raise ValueError("the kernels need at least one row")
    expected = {"indptr": (op.indptr, torch.int32, op.n_pad + 1),
                "indices": (op.indices, torch.int32, nnz),
                "vals": (op.vals, torch.float32, nnz)}
    expected.update((name, (t, torch.float32, length))
                    for name, (t, length) in vectors.items() if t is not None)
    for name, (t, dtype, length) in expected.items():
        if (t.device != dev or t.dtype != dtype or t.shape != (length,)
                or not t.is_contiguous()):
            raise ValueError(
                f"{name}: {t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()}); the kernel takes "
                f"contiguous {dtype} ({length},) on {dev}")


def _raise_on(rc: int, name: str, lib):
    if rc != 0:
        msg = lib.slt_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({msg})")


def csr_spmv(op: CsrOperator, x: torch.Tensor, diag=None) -> torch.Tensor:
    """y = R x, plus diag * x when ``diag`` is given (f32)."""
    if x.device.type == "cpu":
        return csr_spmv_plain(op, x, diag)
    from ._kernels import library

    n = op.n_pad
    _check_operands(op, x=(x, op.m_pad), diag=(diag, n))
    lib = library()
    y = torch.empty(n, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    LAUNCHES["csr_spmv"] += 1
    rc = lib.slt_csr_spmv(
        x.device.index or 0, n, _ptr(op.indptr), _ptr(op.indices),
        _ptr(op.vals), _ptr(x), _ptr(diag), _ptr(y),
        ctypes.c_void_p(stream))
    _raise_on(rc, "csr_spmv", lib)
    return y


def neumann_chain(op: CsrOperator, term0: torch.Tensor, iters: int,
                  with_residual=False):
    """``iters`` launches of ``neumann_step`` from ``term0`` (f32); returns
    ``(acc, last_term)`` plus ``res`` (vector, or 0-d ||res||^2 for
    ``"norm"``) as ``CsrOperator.neumann_chain`` documents."""
    if iters < 1:
        raise ValueError(f"neumann_chain needs iters >= 1, got {iters}")
    if with_residual not in (False, True, "norm"):
        raise ValueError(f"with_residual must be False, True or 'norm', "
                         f"got {with_residual!r}")
    if term0.device.type == "cpu":
        return neumann_chain_plain(op, term0, iters, with_residual)
    from ._kernels import library

    n = op.n_pad
    _check_operands(op, term0=(term0, n), inv_diag=(op.inv_diag, n))
    lib = library()
    acc = term0.clone()
    # ping-pong: a row's gather reads other rows of t_in, so t_out is
    # never the buffer being read
    bufs = (torch.empty_like(term0), torch.empty_like(term0))
    norm = with_residual == "norm"
    res = torch.empty_like(term0) if with_residual and not norm else None
    res2 = (torch.zeros((), dtype=torch.float64, device=term0.device)
            if norm else None)
    stream = ctypes.c_void_p(torch.cuda.current_stream(term0.device).cuda_stream)
    device = term0.device.index or 0
    t_in = term0
    for j in range(iters):
        last = j == iters - 1
        t_out = bufs[j % 2]
        LAUNCHES["neumann_step"] += 1
        rc = lib.slt_neumann_step(
            device, n, _ptr(op.indptr), _ptr(op.indices), _ptr(op.vals),
            _ptr(t_in), _ptr(op.inv_diag), _ptr(t_out), _ptr(acc),
            _ptr(res if last else None), _ptr(res2 if last else None),
            stream)
        _raise_on(rc, "neumann_step", lib)
        t_in = t_out
    if norm:
        return acc, t_in, res2.to(torch.float32)
    if with_residual:
        return acc, t_in, res
    return acc, t_in
