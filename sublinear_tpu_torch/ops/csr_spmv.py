"""Diagonal-split CSR operator and its hand-written CUDA kernels.

``CsrOperator`` is the port's counterpart of
``sublinear_tpu/ops/xbar.py::XbarOperator``.  It keeps that operator's
contract (``matvec``, ``offdiag_matvec``, ``chain_ready``, ``neumann_chain``
with the same outputs) but not its layout: the XBAR route tables, int16
lanes and 16384-row padding exist because the TPU has no fast arbitrary
gather.  Here the off-diagonal entries are a plain CSR (int32 ``indptr`` and
``indices``, f32 values), the diagonal is split out into f32 ``diag`` and
``inv_diag`` of length n, and no domain is padded.

Kernels (``csrc/csr_kernels.cu``, built by ``ops/_kernels.py``):
  ``csr_spmv``      y = R x (+ diag * x): replaces ``_fused_call`` and
                    ``_k1_call`` + ``_k2_call``; one thread block streams
                    each block of ``CsrOperator.row_blocks``;
  ``neumann_step``  ``_chain_call``: ``neumann_chain`` runs a whole chain
                    of Neumann steps as one cooperative launch;
  ``cg_step``       ``_cg_chain_call``: ``cg_chain`` runs a whole chain of
                    Jacobi-PCG steps (product and p.q, update and r.z,
                    direction) as one cooperative launch.
Both chains compute each step's product with ``csr_spmv``'s row-block
stream, so their products equal ``csr_spmv``'s bit for bit.
Kernel (``csrc/spmm_kernels.cu``):
  ``csr_spmm``      Y = R X (+ diag * X) for a block of columns X (m, B),
                    with the f32 product (``CsrOperator.matmat``, the batch
                    path) or ``onehot_spmm``'s two bf16 products
                    (``ops/tiled_spmm.py``): replaces ``onehot_spmm``.
Each has a plain PyTorch version beside it (``csr_spmv_plain``,
``neumann_chain_plain``, ``cg_chain_plain``, ``csr_spmm_plain``).  A CPU
tensor takes the plain version; a CUDA tensor launches the kernel or raises.
``LAUNCHES`` counts kernel launches (one per chain for the two chains),
``STEPS`` the steps the chains ran.  While a profiler records,
``neumann_chain`` also counts each chain and its steps on either device
(``tracing``'s ``neumann_chain_calls`` and ``neumann_chain_steps``).  A
CUDA graph's capture launches nothing and its replay runs no wrapper: inside
``recording()`` the wrappers list their launches instead of counting them,
and ``replayed(list)`` counts them at each replay (``solvers/neumann.py``).
The wrappers check an operator's own arrays once (cached against their data
pointers) and each call's vectors every call.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from .. import tracing
from ..config import to_device, to_host
from ..formats.csr import CSR
from ._kernels import library, ptr, raise_on, stream_of
from .dense_fused import split_bf16

LAUNCHES = {"csr_spmv": 0, "neumann_step": 0, "cg_step": 0, "csr_spmm": 0}
STEPS = {"neumann_step": 0, "cg_step": 0}
# csr_spmm's products: f32, onehot_spmm(precise=True), onehot_spmm(precise=False)
SPMM_MODES = {"f32": 0, "split": 1, "bf16": 2}

_INT32_LIMIT = 2**31
TINY = 1e-30  # _cg_chain_call's guard on p.q and rz
# csr_spmv's row blocks (kTile, kTileRows and kLongRow in csrc/csr_kernels.cu):
# at most SPMV_TILE off-diagonal entries and SPMV_ROWS rows per block, and a
# row of more than SPMV_LONG_ROW entries is a block of its own
SPMV_TILE, SPMV_ROWS, SPMV_LONG_ROW = 1024, 256, 64


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
        self._nnz = nnz
        self.diag_split = diag_split  # diagonal excluded from the CSR
        self._row_ids = None
        self._row_blocks = None
        self._checked = None  # (data pointers, kernel arguments) once checked

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
                torch.arange(self.shape[0], device=self.device), counts)
        return self._row_ids

    @property
    def row_blocks(self) -> torch.Tensor:
        """``csr_spmv``'s partition of the rows (int32, on the operator's
        device): ``spmv_row_blocks`` of ``indptr``, built at first use."""
        if self._row_blocks is None:
            with tracing.span("slt.csr.row_blocks"):
                self._row_blocks = to_device(
                    spmv_row_blocks(to_host(self.indptr)), torch.int32,
                    self.device)
        return self._row_blocks

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        diag = self.diag if self.diag_split else None
        return csr_spmv(self, x.to(torch.float32), diag).to(x.dtype)

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        """Y = A X for a block of columns X (m, B), through ``csr_spmm``."""
        diag = self.diag if self.diag_split else None
        return csr_spmm(self, X.to(torch.float32).contiguous(), diag,
                        "f32").to(X.dtype)

    def offdiag_matvec(self, x: torch.Tensor) -> torch.Tensor:
        if self.diag_split:
            return csr_spmv(self, x.to(torch.float32), None).to(x.dtype)
        return self.matvec(x) - self.diag * x

    @property
    def chain_ready(self) -> bool:
        """True when the Neumann and CG recurrences can run as chains
        (``neumann_chain``, ``cg_chain``): a square operator with the
        diagonal split out (every square CsrOperator)."""
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
        """Runs ``iters`` Jacobi-PCG iterations from the state (x, r, p, rz):
        returns ``(x, r, p, rz, res2)`` with res2 = ||r||^2 of the final
        iterate; ``rz`` and ``res2`` are 0-d f32 tensors on the operator's
        device.  Seeding the next call with the returned state continues the
        recurrence exactly (the chunked driver in solvers/cg.py).  Vectors
        come back in ``x``'s dtype (the chain runs in f32); the inputs are
        not modified."""
        if not self.chain_ready:
            raise ValueError(
                "cg_chain requires a chain-ready operator (square, diagonal "
                f"split out); this operator has shape={self.shape}, "
                f"diag_split={self.diag_split} - use the per-step solver path")
        dt = x.dtype
        f32 = torch.float32
        rz = torch.as_tensor(rz, dtype=f32, device=x.device).reshape(())
        xo, ro, po, rzo, res2 = cg_chain(
            self, *(v.to(f32).contiguous() for v in (x, r, p)), rz, int(iters))
        return xo.to(dt), ro.to(dt), po.to(dt), rzo, res2


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


def spmv_row_blocks(indptr, tile: int = SPMV_TILE, rows: int = SPMV_ROWS,
                    long_row: int = SPMV_LONG_ROW) -> np.ndarray:
    """Cut the rows of a CSR with row pointer ``indptr`` into ``csr_spmv``'s
    row blocks: returns the ascending row numbers (int32) that start each
    block, then n.  Greedy from row 0: a row of more than ``long_row``
    entries is a block of its own; any other block takes as many rows as
    keep it within ``tile`` entries and ``rows`` rows, and stops before a
    long row.  The limits must be the kernel's (the defaults; other values
    only for a kernel built with them, as sweep_sparse_kernels.py does)."""
    indptr = np.asarray(indptr, dtype=np.int64)
    n = indptr.size - 1
    # the long rows in order, then n as a sentinel
    long_rows = np.flatnonzero(np.diff(indptr) > long_row).tolist() + [n]
    starts, r, li = [], 0, 0
    while r < n:
        starts.append(r)
        if long_rows[li] == r:
            r, li = r + 1, li + 1
            continue
        # the last row boundary within `tile` entries of row r's start
        fit = int(np.searchsorted(indptr, indptr[r] + tile, side="right")) - 1
        r = min(fit, r + rows, long_rows[li])
    starts.append(n)
    return np.asarray(starts, dtype=np.int32)


_recorder = threading.local()  # .log: the list ``recording`` fills


def _launched(name: str, steps: int = 0) -> None:
    """Count one launch of kernel ``name`` (a chain of ``steps`` steps) in
    ``LAUNCHES`` and ``STEPS``, and a Neumann chain in ``tracing`` too;
    while this thread records (``recording``), list it there instead."""
    log = getattr(_recorder, "log", None)
    if log is not None:
        log.append((name, steps))
        return
    LAUNCHES[name] += 1
    if steps:
        STEPS[name] += steps
    if name == "neumann_step":
        _count_chain(steps)


def _count_chain(steps: int) -> None:
    tracing.count("neumann_chain_calls")
    tracing.count("neumann_chain_steps", steps)


@contextlib.contextmanager
def recording():
    """While open, the kernels this thread's wrappers launch are listed in
    the list it yields, as ``(name, steps)``, and counted nowhere: a CUDA
    graph's capture records them without running them."""
    _recorder.log = log = []
    try:
        yield log
    finally:
        _recorder.log = None


def replayed(log: list) -> None:
    """Count the launches ``recording`` listed, for one replay of the
    graph captured while it was open."""
    for name, steps in log:
        _launched(name, steps)


# ---------------------------------------------------------------- plain

def csr_spmv_plain(op: CsrOperator, x: torch.Tensor, diag=None):
    """y = R x (+ diag * x) with index_select / index_add_."""
    n = op.shape[0]
    y = torch.zeros(n, dtype=x.dtype, device=x.device)
    y.index_add_(0, op.row_ids, op.vals * x.index_select(0, op.indices))
    if diag is not None:
        y = y + diag * x[:n]
    return y


def _check_mode(mode: str):
    if mode not in SPMM_MODES:
        raise ValueError(f"mode must be one of {sorted(SPMM_MODES)}, got "
                         f"{mode!r}")


def csr_spmm_plain(op: CsrOperator, X: torch.Tensor, diag=None,
                   mode: str = "f32"):
    """Y = R X (+ diag * X) with index_select / index_add_; ``mode`` picks
    the product of each stored entry as ``csr_spmm`` documents (the bf16
    modes in f32, with the JAX package's bf16 splits)."""
    _check_mode(mode)
    v, Xg = op.vals[:, None], X.index_select(0, op.indices)
    if mode == "f32":
        P = v * Xg
    elif mode == "split":
        (vh, vl), (xh, xl) = ([h.float() for h in split_bf16(a)]
                              for a in (v, Xg))
        ph, plo = split_bf16(vh * xh + vh * xl + vl * xh)
        P = ph.float() + plo.float()
    else:
        vh, xh = split_bf16(v)[0].float(), split_bf16(Xg)[0].float()
        P = split_bf16(vh * xh)[0].float()
    n = op.shape[0]
    Y = torch.zeros((n, X.shape[1]), dtype=X.dtype, device=X.device)
    Y.index_add_(0, op.row_ids, P)
    if diag is not None:
        Y = Y + diag[:, None] * X[:n]
    return Y


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


def dot64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b accumulated in f64 and rounded to f32 (0-d), as the CG kernel
    reduces its dots."""
    return torch.dot(a.double(), b.double()).to(torch.float32)


def cg_chain_plain(op: CsrOperator, x, r, p, rz, iters: int):
    """The chain of ``cg_step`` passes, in plain PyTorch: the kernel's
    arithmetic step by step (f64 dots rounded to f32, f32 vector updates
    without fused multiply-adds)."""
    if iters < 1:
        raise ValueError(f"cg_chain needs iters >= 1, got {iters}")
    x, r, p = x.clone(), r.clone(), p.clone()
    for _ in range(iters):
        q = csr_spmv_plain(op, p, op.diag)
        alpha = rz / torch.clamp(dot64(p, q), min=TINY)
        x = x + alpha * p
        r = r - alpha * q
        z = op.inv_diag * r
        rz_new = dot64(r, z)
        beta = rz_new / torch.clamp(rz, min=TINY)
        p = z + beta * p
        rz = rz_new
    return x, r, p, rz, dot64(r, r)


# ---------------------------------------------------------------- kernels

def _operator_args(op: CsrOperator) -> tuple:
    """``(device index, indptr, indices, vals)`` of ``op``'s CSR as kernel
    arguments, after raising unless its arrays are what the kernels take:
    contiguous int32 / int32 / f32 of the right lengths on one CUDA device,
    fewer than 2**31 entries, at least one row.  The check runs once per set
    of arrays: the result is cached against their data pointers."""
    arrays = (op.indptr, op.indices, op.vals)
    key = tuple(t.data_ptr() for t in arrays)
    if op._checked is not None and op._checked[0] == key:
        return op._checked[1]
    dev = op.vals.device
    if dev.type != "cuda":
        raise ValueError(f"CUDA kernel operands on {dev}")
    nnz = op.indices.numel()
    if nnz >= _INT32_LIMIT:
        raise ValueError("nnz >= 2**31 does not fit the kernels' int32 CSR")
    if op.shape[0] < 1:
        raise ValueError("the kernels need at least one row")
    index = dev.index or 0
    for name, t, dtype, length in (("indptr", op.indptr, torch.int32,
                                    op.shape[0] + 1),
                                   ("indices", op.indices, torch.int32, nnz),
                                   ("vals", op.vals, torch.float32, nnz)):
        _check_tensor(name, t, (length,), index, dtype)
    args = (index, *key)
    op._checked = (key, args)
    op._row_blocks = None  # cut anew from the arrays just checked
    return args


def _check_tensor(name: str, t: torch.Tensor, shape: tuple, index: int,
                  dtype=torch.float32):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    CUDA device ``index``."""
    if not (t.is_cuda and t.get_device() == index and t.dtype == dtype
            and t.shape == shape and t.is_contiguous()):
        raise ValueError(
            f"{name}: {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()}); the kernel takes contiguous "
            f"{dtype} {shape} on cuda:{index}")


def _check_operands(op: CsrOperator, **operands) -> tuple:
    """Raise unless the operator's arrays (``_operator_args``) and the
    ``name=(tensor, shape)`` operands are what the kernels take: contiguous
    f32 tensors of the right shapes on the operator's CUDA device (a shape
    is a length or a tuple; None tensors are skipped).  Returns
    ``_operator_args(op)``."""
    args = _operator_args(op)
    for name, (t, shape) in operands.items():
        if t is not None:
            _check_tensor(name, t,
                          shape if isinstance(shape, tuple) else (shape,),
                          args[0])
    return args


def csr_spmv(op: CsrOperator, x: torch.Tensor, diag=None) -> torch.Tensor:
    """y = R x, plus diag * x when ``diag`` is given (f32)."""
    if x.is_cpu:
        return csr_spmv_plain(op, x, diag)

    device, indptr, indices, vals = _operator_args(op)
    n, m = op.shape
    _check_tensor("x", x, (m,), device)
    if diag is not None:
        _check_tensor("diag", diag, (n,), device)
    blocks = op.row_blocks
    lib = library("csr_kernels")
    y = x.new_empty(n)
    _launched("csr_spmv")
    rc = lib.slt_csr_spmv(device, blocks.numel() - 1, blocks.data_ptr(),
                          indptr, indices, vals, x.data_ptr(), ptr(diag),
                          y.data_ptr(), stream_of(x))
    raise_on(rc, "csr_spmv", lib)
    return y


def csr_spmm(op: CsrOperator, X: torch.Tensor, diag=None,
             mode: str = "f32") -> torch.Tensor:
    """Y (n, B) = R X, plus diag[:, None] * X when ``diag`` is given, for
    X (m, B) f32.  ``mode``: "f32" (v * x), "split" (onehot_spmm's
    precise bf16 hi/lo product) or "bf16" (bf16(bf16(v) * bf16(x)))."""
    _check_mode(mode)
    n, m = op.shape
    if X.dim() != 2 or X.shape[0] != m or X.shape[1] < 1:
        raise ValueError(f"X must be (m={m}, B) with B >= 1, got "
                         f"{tuple(X.shape)}")
    if X.is_cpu:
        return csr_spmm_plain(op, X, diag, mode)

    B = X.shape[1]
    if diag is not None and m != n:
        raise ValueError(f"diag needs a square operator, got {op.shape}")
    device, indptr, indices, vals = _check_operands(
        op, X=(X, (m, B)), diag=(diag, n))
    lib = library("spmm_kernels")
    Y = X.new_empty((n, B))
    _launched("csr_spmm")
    rc = lib.slt_csr_spmm(device, SPMM_MODES[mode], n, m, B, indptr,
                          indices, vals, X.data_ptr(), ptr(diag),
                          Y.data_ptr(), stream_of(X))
    raise_on(rc, "csr_spmm", lib)
    return Y


def neumann_chain(op: CsrOperator, term0: torch.Tensor, iters: int,
                  with_residual=False):
    """``iters`` Neumann steps from ``term0`` (f32) in one launch of the
    ``neumann_step`` chain kernel; returns ``(acc, last_term)`` plus ``res``
    (vector, or 0-d ||res||^2 for ``"norm"``) as
    ``CsrOperator.neumann_chain`` documents."""
    if iters < 1:
        raise ValueError(f"neumann_chain needs iters >= 1, got {iters}")
    if with_residual not in (False, True, "norm"):
        raise ValueError(f"with_residual must be False, True or 'norm', "
                         f"got {with_residual!r}")
    if term0.is_cpu:
        _count_chain(iters)
        return neumann_chain_plain(op, term0, iters, with_residual)

    n = op.shape[0]
    device, indptr, indices, vals = _check_operands(
        op, term0=(term0, n), inv_diag=(op.inv_diag, n))
    blocks = op.row_blocks
    lib = library("csr_kernels")
    acc = term0.clone()
    # ping-pong: a row's gather reads other rows of t_in, so t_out is
    # never the buffer being read; step j writes bufs[j % 2]
    bufs = (torch.empty_like(term0), torch.empty_like(term0))
    norm = with_residual == "norm"
    res = torch.empty_like(term0) if with_residual and not norm else None
    res2 = (torch.zeros((), dtype=torch.float64, device=term0.device)
            if norm else None)
    _launched("neumann_step", iters)
    rc = lib.slt_neumann_chain(
        device, blocks.numel() - 1, blocks.data_ptr(), indptr, indices, vals,
        ptr(op.inv_diag), ptr(term0), ptr(bufs[0]), ptr(bufs[1]), ptr(acc),
        ptr(res), ptr(res2), iters, stream_of(term0))
    raise_on(rc, "neumann_step", lib)
    last = bufs[(iters - 1) % 2]
    if norm:
        return acc, last, res2.to(torch.float32)
    if with_residual:
        return acc, last, res
    return acc, last


def cg_chain(op: CsrOperator, x, r, p, rz, iters: int, *, q_out=None):
    """``iters`` CG steps from the f32 state (x, r, p) and the 0-d f32
    ``rz`` in one launch of the ``cg_step`` chain kernel; returns
    ``(x, r, p, rz, res2)`` as ``CsrOperator.cg_chain`` documents.  On the
    card the state is copied once and then updated in place by the kernel.
    ``q_out``, an (n,) f32 tensor on the card, receives the last step's
    product q = A p (a check of the kernel's product)."""
    if iters < 1:
        raise ValueError(f"cg_chain needs iters >= 1, got {iters}")
    if x.is_cpu:
        return cg_chain_plain(op, x, r, p, rz, iters)

    n = op.shape[0]
    device, indptr, indices, vals = _check_operands(
        op, x=(x, n), r=(r, n), p=(p, n), diag=(op.diag, n),
        inv_diag=(op.inv_diag, n), q_out=(q_out, n))
    if rz.device != x.device or rz.dtype != torch.float32 or rz.dim() != 0:
        raise ValueError(f"rz: {rz.dtype} {tuple(rz.shape)} on {rz.device}; "
                         f"the kernel takes a 0-d float32 tensor on {x.device}")
    blocks = op.row_blocks
    lib = library("csr_kernels")
    x, r, p = x.clone(), r.clone(), p.clone()
    q = torch.empty_like(x) if q_out is None else q_out
    # step j: p.q in slot 2j+1, r.z in 2j+2; r.r in the last slot
    scal = torch.zeros(2 * iters + 2, dtype=torch.float64, device=x.device)
    out = torch.empty(2, dtype=torch.float32, device=x.device)
    _launched("cg_step", iters)
    rc = lib.slt_cg_chain(
        device, n, blocks.numel() - 1, blocks.data_ptr(), indptr, indices,
        vals, *map(ptr, (op.diag, op.inv_diag, x, r, p, q, scal, rz)), iters,
        ptr(out), stream_of(x))
    raise_on(rc, "cg_step", lib)
    return x, r, p, out[0], out[1]
