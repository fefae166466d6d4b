"""Batched solves, as in ``sublinear_tpu/parallel/sharded.py`` (its
single-device part: ``solve_batch``).

``solve_batch`` solves A X = B for a block of right-hand sides at once, each
column held to its own threshold.  The JAX package runs a batch inside one
``lax.while_loop``; here ``_neumann_batch_run`` and ``_cg_batch_run`` are host
loops with the same recurrences and stop rule that read the column
residuals back once per iteration, so the iteration counts match.  Each
iteration's product is ``op.matmat`` on ``Matrix.op(batch=True)``: on the
``"csr"`` route, the ``csr_spmm`` kernel (``ops/csr_spmv.py``).  Both run
n-major ((n, B) state) on every operator; the JAX package's batch-major
branch is a layout for its TPU gathers.  A Neumann batch of at most
``CHAIN_MAX_RHS`` columns on a chain-ready operator runs as serialized chain
solves (``solvers/neumann.py::_neumann_run`` per column, the
``neumann_step`` kernel), as in the JAX package.

B and X cross between host and device once each and are converted on the
device: B goes up in the caller's own dtype and strides, and its column
norms and its copy in the operator's dtype are made there (``_prepare``); X
comes down widened to float64 (``config.to_host``), into pinned host memory
on a CUDA device.  A B larger than one staging chunk goes up to a CUDA device
through a bounded ring of pinned buffers, the host filling one while the
card copies the ones before it (``_staged_upload``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..config import to_host
from ..errors import DimensionMismatchError
from ..matrix import Matrix
from ..solvers import base
from ..solvers.neumann import _neumann_run
from ..types import SolverOptions, SolverResult

_TINY = 1e-30
CHAIN_MAX_RHS = 32
# B's route to a CUDA device: chunks of _STAGE_BYTES through _STAGE_DEPTH
# pinned buffers (sizes chosen by a sweep on an H100, PERF.md §6)
_STAGE_BYTES = 16 << 20
_STAGE_DEPTH = 3


def _col_norms(R: torch.Tensor) -> np.ndarray:
    """The column 2-norms of R read back to the host: a blocking read,
    counted as one ``host_syncs`` and its bytes in ``d2h_bytes``."""
    norms = torch.linalg.vector_norm(R, dim=0)
    tracing.count_read(norms.numel() * norms.element_size())
    return norms.cpu().numpy()


def _running(res: np.ndarray, thresholds: np.ndarray, k: int,
             max_iters: int) -> bool:
    """The JAX loop's condition on host copies of the column residuals and
    the thresholds (both in the operator's dtype)."""
    return bool(np.any(res > thresholds) and k < max_iters
                and np.all(np.isfinite(res)))


@tracing.traced("slt.loop")
def _cg_batch_run(op, B, thresholds, max_iters):
    """Jacobi-preconditioned CG over the columns of B (n, nrhs) from X = 0,
    with per-column ``thresholds``.  Returns (X, k, host column
    residuals)."""
    inv_d = op.inv_diag[:, None]
    X = torch.zeros_like(B)
    R = B - op.matmat(X)
    Z = inv_d * R
    P = Z
    rz = torch.sum(R * Z, dim=0)
    k = 0
    # the loop's one device-to-host sync per iteration
    while _running(_col_norms(R), thresholds, k, max_iters):
        AP = op.matmat(P)
        alpha = rz / torch.clamp(torch.sum(P * AP, dim=0), min=_TINY)
        X = X + alpha * P
        R = R - alpha * AP
        Z = inv_d * R
        rz_new = torch.sum(R * Z, dim=0)
        P = Z + rz_new / torch.clamp(rz, min=_TINY) * P
        rz = rz_new
        k += 1
    return X, k, _col_norms(R)


@tracing.traced("slt.loop")
def _neumann_batch_run(op, B, thresholds, max_iters):
    """The batched Neumann series from X = 0 (the JAX package's
    ``x0_zero=True``), with per-column ``thresholds``.  The residual identity
    r(X_k) = -R_off T_k gives each iteration's column residuals from its own
    product; the first check is forced by a large finite seed and k starts
    at 1.  The returned residuals are the exact B - A X column norms,
    measured once after the loop.  Returns (X, k, host column residuals)."""
    inv_d, diag = op.inv_diag[:, None], op.diag[:, None]
    T = inv_d * B
    X = T
    k = 1
    res = np.full(B.shape[1], torch.finfo(B.dtype).max / 4)
    while _running(res, thresholds, k, max_iters):
        RT = op.matmat(T) - diag * T
        res = _col_norms(RT)
        T = -inv_d * RT
        X = X + T
        k += 1
    return X, k, _col_norms(B - op.matmat(X))


def _chain_columns(op, Bt, thr_cols, options: SolverOptions):
    """One chain solve per row of Bt (nrhs, n): returns (X (n, nrhs), the
    largest iteration count, host column residuals)."""
    xs, ks, ress = [], [], []
    for b, thr in zip(Bt, thr_cols):
        x, k, res, *_ = _neumann_run(op, b, torch.zeros_like(b), float(thr),
                                     options.max_iterations,
                                     options.check_every)
        xs.append(x)
        ks.append(k)
        ress.append(res)
    return torch.stack(xs, dim=1), max(ks), np.asarray(ress)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """The memory of a dense tensor with no negative stride as one flat
    uint8 tensor, in memory order."""
    return t.as_strided((t.numel(),), (1,)).view(torch.uint8)


def _staged_upload(src: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """The host tensor ``src`` copied to ``dev``, with the strides that
    ``src.to(dev)`` gives it, through a ring of ``_STAGE_DEPTH`` host
    buffers of ``_STAGE_BYTES``.  Its memory goes up as flat chunks in
    memory order, so a C- and an F-ordered block take the same walk: the
    host fills a buffer from one chunk (torch's threaded ``copy_``) and
    queues its copy on the current stream, then fills the next while the
    card copies; it refills a buffer only once the event recorded after
    that buffer's last copy has passed.  The buffers come from torch's
    caching host allocator, pinned for a CUDA ``dev``, and go back to it
    when the call returns, so a call holds at most ``_STAGE_BYTES *
    _STAGE_DEPTH`` pinned bytes whatever src's size, and nothing is kept
    by the caller's buffer.  For a CPU ``dev`` the buffers are plain
    memory and every copy is done when it returns."""
    dst = torch.empty_like(src, device=dev)
    if dst.stride() != src.stride():  # not dense: laid out as dst first
        src = torch.empty_like(src).copy_(src)
    pin = dev.type == "cuda"
    stream = torch.cuda.current_stream(dev) if pin else None
    ring = [(torch.empty(_STAGE_BYTES, dtype=torch.uint8, pin_memory=pin),
             torch.cuda.Event() if pin else None)
            for _ in range(_STAGE_DEPTH)]
    src_b, dst_b = _bytes(src), _bytes(dst)
    for i, start in enumerate(range(0, src_b.numel(), _STAGE_BYTES)):
        buf, copied = ring[i % _STAGE_DEPTH]
        if copied is not None:
            copied.synchronize()  # no-op before the buffer's first copy
        chunk = src_b[start:start + _STAGE_BYTES]
        staged = buf[:chunk.numel()].copy_(chunk)
        dst_b[start:start + chunk.numel()].copy_(staged, non_blocking=True)
        if copied is not None:
            copied.record(stream)
    return dst


def _prepare(B: np.ndarray, dtype: torch.dtype, dev: torch.device,
             rows: bool):
    """B on ``dev`` in ``dtype``, contiguous n-major (n, nrhs), or as
    (nrhs, n) rows where ``rows``, and B's float64 column 2-norms read back
    to the host.  B goes up once in its own dtype and strides (an F-ordered
    view goes up F-ordered; on the CPU the tensor shares B's memory), span
    ``slt.to_device``, its bytes counted in ``h2d_bytes``; to a CUDA device
    a B of more than ``_STAGE_BYTES`` goes through ``_staged_upload``, its
    bytes counted in ``pinned_h2d_bytes`` too.  The conversions and the
    transpose run on the device."""
    with tracing.span("slt.to_device"):
        if min(B.strides, default=0) < 0:  # torch takes no negative stride
            B = np.ascontiguousarray(B)
        src = torch.from_numpy(B)
        nbytes = src.numel() * src.element_size()
        if dev.type == "cuda" and nbytes > _STAGE_BYTES:
            B_dev = _staged_upload(src, dev)
            tracing.count("pinned_h2d_bytes", nbytes)
        else:
            B_dev = src.to(dev)
        tracing.count("h2d_bytes", nbytes)
    norms = _col_norms(B_dev.to(torch.float64))
    B_op = B_dev.to(dtype)
    return (B_op.T if rows else B_op).contiguous(), norms


@tracing.traced("slt.solve_batch")
def solve_batch(
    matrix: Matrix,
    B,
    options: Optional[SolverOptions] = None,
    mesh=None,
    raise_on_fail: bool = False,
    method: str = "auto",
):
    """Solve A X = B for many RHS at once (B: (n, nrhs)); returns one
    SolverResult per column, with method ``f"{method}-batch"``.

    ``method``: 'cg' | 'neumann' | 'auto' (CG when symmetric, else the
    DD-convergent batched Neumann series); any other string runs CG, as in
    the JAX package.  Columns that do not converge are reported with
    ``converged=False`` (``raise_on_fail`` is accepted for the JAX
    signature and, as there, not acted on).  ``mesh`` is not ported yet.

    Each solution is a column view of one float64 (n, nrhs) host array; on
    a CUDA device that array is a view of a pinned tensor
    (``config.to_host``), held by the solutions.  No NumPy pass runs over
    B or X: a float32 or float64 B is uploaded as given (any other dtype is
    made float64 first) and converted on the device."""
    options = options or SolverOptions()
    n = matrix.shape[0]
    B = np.asarray(B)
    if B.dtype != np.float32:
        B = np.asarray(B, dtype=np.float64)
    if B.ndim != 2 or B.shape[0] != n:
        raise DimensionMismatchError(f"batch RHS must be (n, k), got {B.shape}")
    if mesh is not None:
        raise NotImplementedError(
            "solve_batch over a device mesh is not ported yet (ROADMAP queue "
            "1, item 11)")

    nrhs = B.shape[1]
    op = matrix.op(options.dtype, batch=True)

    if method == "auto":
        from ..analysis import analyze

        a = analyze(matrix, estimate_condition=False)
        method = "cg" if a.is_symmetric else (
            "neumann" if a.is_diagonally_dominant else "cg"
        )
    # small-batch path: serialized chain solves, each column with its own
    # convergence check (the JAX package's conditions)
    chain_op = None
    if method == "neumann" and nrhs <= CHAIN_MAX_RHS and options.x0 is None:
        op1 = matrix.op(options.dtype)
        if base.chained(op1, options.check_every):
            chain_op = op1

    with base.SolveTimer(matrix.device) as t:
        B_dev, norms = _prepare(B, (chain_op or op).dtype, matrix.device,
                                rows=chain_op is not None)
        # Per-column thresholds: eps * ||b_j|| for 'relative', so a column
        # whose RHS norm is orders of magnitude below its neighbours still
        # meets its OWN relative tolerance (not eps * max_j ||b_j||).
        if options.convergence == "relative":
            thr_cols = float(options.epsilon) * np.maximum(norms, 1e-30)
        else:
            thr_cols = np.full(nrhs, float(options.epsilon))
        if chain_op is not None:
            X, k, col_res = _chain_columns(chain_op, B_dev, thr_cols, options)
        else:
            np_dtype = torch.empty(0, dtype=op.dtype).numpy().dtype
            run = _neumann_batch_run if method == "neumann" else _cg_batch_run
            X, k, col_res = run(op, B_dev, thr_cols.astype(np_dtype),
                                options.max_iterations)
        del B_dev  # freed before X is widened: the peak stays the loop's
        X = X.to(torch.float64)

    X_host = to_host(X)
    res = np.asarray(col_res, dtype=np.float64)
    return [
        SolverResult(
            solution=X_host[:, j],
            iterations=int(k),
            residual=float(res[j]),
            converged=bool(res[j] <= thr_cols[j] * 1.0000001),
            method=f"{method}-batch",
            compute_time_ms=t.ms,
        )
        for j in range(nrhs)
    ]
