"""Public host-side Matrix wrapper, as in ``sublinear_tpu/matrix.py``.

Host CSR for construction and analysis, plus lazily built device operators
on the Matrix's torch device.  The operator kind is chosen on the host in
the JAX package's predicate order: DIA if the matrix is banded, else the
sparse kernel (``"csr"``, the JAX package's ``"xbar"``) if it is large and
sparse, else dense for n <= ``DENSE_THRESHOLD``, else ELL.  The sparse
kernel has no size ceiling: the TPU-geometry test the JAX package applies
(``xbar_feasible``) is not ported, so n = 1M takes ``"csr"`` where the JAX
package falls back to ELL.

The batch route (``op(batch=True)``, the multi-RHS product of
``solve_batch``) differs on purpose too.  The JAX package never batches on
its crossbar operator, so a large sparse matrix takes ELL there.  The port's
``"csr"`` operator has a batched product (``CsrOperator.matmat``, the
``csr_spmm`` kernel that replaces ``onehot_spmm``), so above
``DENSE_THRESHOLD`` a large sparse matrix takes ``"csr"`` for batches too;
at and below it both packages keep the dense route.
"""
from __future__ import annotations

import itertools
import threading
from typing import Optional

import numpy as np

from . import config, tracing
from .config import DENSE_THRESHOLD
from .errors import DimensionMismatchError, InvalidMatrixError
from .formats import ell as _ell
from .formats.csr import CSR

_UID = itertools.count()

# ``prefer="xbar"`` names the same operator kind as the JAX package, so a
# test can pass one argument to both packages.
_KIND_ALIASES = {"xbar": "csr"}


class Matrix:
    """Square-or-rectangular sparse/dense matrix with device-operator cache.

    What is derived from ``csr`` (the operators, the DIA probe, the
    transpose, PageRank's P^T) is built once and kept on the object, so
    ``csr`` must not be mutated after construction."""

    def __init__(self, csr: CSR, prefer: Optional[str] = None, device=None):
        self.csr = csr
        # None | 'dense' | 'ell' | 'dia' | 'csr'
        self._prefer = _KIND_ALIASES.get(prefer, prefer)
        self.device = config.device(device)
        self._ops: dict = {}
        self._dia_offsets: Optional[tuple] = ()  # () = unprobed, None = ineligible
        self._dom_gap: Optional[float] = None
        self._transpose_csr: Optional[CSR] = None
        # graph/pagerank.py's (P^T operator, dangling mask) per dtype
        self._pagerank: dict = {}
        # serving layers share Matrix objects across threads
        self._lock = threading.Lock()
        # process-unique id for external caches (id() is reused after GC)
        self.uid = next(_UID)

    # ------------------------------------------------------------ constructors
    @classmethod
    @tracing.traced("slt.matrix.from_coo")
    def from_coo(cls, rows, cols, vals, shape, **kw) -> "Matrix":
        return cls(CSR.from_coo(rows, cols, vals, shape), **kw)

    @classmethod
    def from_dense(cls, data, **kw) -> "Matrix":
        return cls(CSR.from_dense(data), **kw)

    @classmethod
    def from_csr_arrays(cls, indptr, indices, data, shape, **kw) -> "Matrix":
        return cls(CSR(indptr, indices, data, shape), **kw)

    @classmethod
    def from_dict(cls, d: dict, **kw) -> "Matrix":
        """Parse the reference's JSON matrix format (src/core/types.ts:6-23):
        COO triplets {rows, cols, values, rowIndices, colIndices,
        format:'coo'} or dense {rows, cols, data, format:'dense'}."""
        if not isinstance(d, dict):
            raise InvalidMatrixError("matrix must be an object")
        fmt = d.get("format", "dense" if "data" in d else "coo")
        rows, cols = d.get("rows"), d.get("cols")
        if fmt == "dense":
            data = np.asarray(d["data"], dtype=np.float64)
            if rows is not None and data.shape != (rows, cols):
                raise DimensionMismatchError(
                    f"dense data shape {data.shape} != declared ({rows}, {cols})"
                )
            return cls.from_dense(data, **kw)
        if fmt in ("coo", "csr", "csc"):
            if rows is None or cols is None:
                raise InvalidMatrixError("sparse matrix requires rows/cols fields")
            ri = d.get("rowIndices", d.get("row_indices"))
            ci = d.get("colIndices", d.get("col_indices"))
            vals = d.get("values")
            if ri is None or ci is None or vals is None:
                raise InvalidMatrixError("sparse matrix requires values/rowIndices/colIndices")
            return cls.from_coo(ri, ci, vals, (rows, cols), **kw)
        raise InvalidMatrixError(f"unknown matrix format: {fmt}")

    @classmethod
    def identity(cls, n: int, **kw) -> "Matrix":
        return cls(CSR.identity(n), **kw)

    @classmethod
    def diagonal(cls, d, **kw) -> "Matrix":
        return cls(CSR.diagonal(d), **kw)

    # ------------------------------------------------------------ properties
    @property
    def shape(self):
        return self.csr.shape

    @property
    def nnz(self) -> int:
        return self.csr.nnz

    @property
    def density(self) -> float:
        n, m = self.shape
        return self.nnz / max(n * m, 1)

    def is_square(self) -> bool:
        return self.shape[0] == self.shape[1]

    # ------------------------------------------------------------ device ops
    def _use_dense(self) -> bool:
        if self._prefer == "dense":
            return True
        if self._prefer == "ell":
            return False
        n, m = self.shape
        if max(n, m) <= DENSE_THRESHOLD:
            return True
        # moderately sized but dense enough that ELL would be dense anyway
        return max(n, m) <= 4 * DENSE_THRESHOLD and self.density > 0.25

    def _dia_eligible(self):
        """Distinct-offset tuple when A is exactly diagonal-representable
        (banded/tridiagonal/Laplacian), else None.  Probed once."""
        if self._dia_offsets == ():
            from .formats.dia import dia_offsets

            with tracing.span("slt.matrix.dia_probe"):
                offs = dia_offsets(self.csr)
            self._dia_offsets = None if offs is None else tuple(int(o) for o in offs)
        return self._dia_offsets

    def _csr_eligible(self) -> bool:
        """Sparse-kernel eligibility: large and sparse (the JAX package's
        density gate, without its TPU-geometry test)."""
        n, m = self.shape
        return min(n, m) >= 4096 and self.density <= 0.02

    def _op_kind(self, batch: bool = False) -> str:
        if self._prefer in ("dense", "ell", "dia", "csr"):
            return self._prefer
        if self._dia_eligible() is not None:
            return "dia"
        # large sparse: the CSR kernels; a batch keeps the dense route where
        # the matrix is small enough for it
        if self._csr_eligible() and not (batch and self._use_dense()):
            return "csr"
        return "dense" if self._use_dense() else "ell"

    def op(self, dtype=None, transpose: bool = False, batch: bool = False):
        """Device operator (cached per (dtype, transpose, kind)).

        ``batch=True`` asks for the multi-RHS product path (``matmat``):
        a large sparse matrix below ``DENSE_THRESHOLD`` takes the dense
        operator there instead of ``"csr"``."""
        dt = config.resolve_dtype(dtype)
        kind = self._op_kind(batch=batch)
        key = (str(dt), bool(transpose), kind)
        if key not in self._ops:
            with self._lock:
                if key not in self._ops:
                    with tracing.span("slt.matrix.pack"):
                        csr = self.T_csr() if transpose else self.csr
                        # memory guard: raise E007 before packing, not OOM
                        from .formats.streaming import check_memory_budget

                        check_memory_budget(csr, kind, device=self.device)
                        if kind == "dia":
                            from .formats.dia import dia_from_csr

                            self._ops[key] = dia_from_csr(csr, dt, device=self.device)
                        elif kind == "dense":
                            self._ops[key] = _ell.dense_from_csr(csr, dt, self.device)
                        elif kind == "ell":
                            self._ops[key] = _ell.ell_from_csr(csr, dt, device=self.device)
                        else:
                            from .ops.csr_spmv import pack_csr

                            self._ops[key] = pack_csr(csr, self.device)
        return self._ops[key]

    def reorder_rcm(self):
        """Bandwidth-reducing symmetric permutation (reverse Cuthill-McKee,
        on the host).

        Returns ``(B, perm)`` where ``B = P A P^T`` (``B[i, j] =
        A[perm[i], perm[j]]``).  To solve ``A x = b``: solve
        ``B y = b[perm]`` then ``x[perm] = y``.  RCM often shrinks a
        mesh or graph matrix's bandwidth enough for the DIA operator."""
        if not self.is_square():
            raise InvalidMatrixError("RCM reordering requires a square matrix")
        from .ordering import rcm_ordering

        csr, t = self.csr, self.T_csr()
        n = csr.shape[0]
        perm = rcm_ordering(csr.indptr, csr.indices, t.indptr, t.indices, n)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(n)
        rows, cols, vals = csr.to_coo()
        return Matrix.from_coo(inv[rows], inv[cols], vals, self.shape,
                               device=self.device), perm

    def T_csr(self) -> CSR:
        if self._transpose_csr is None:
            self._transpose_csr = self.csr.transpose()
        return self._transpose_csr

    def pad_vector(self, v, dtype=None, transpose: bool = False):
        """A row-space vector (e.g. the RHS b) as a tensor of the operator's
        dtype on the Matrix's device (``config.to_device``).  With
        ``transpose=True``, the transpose operator's row space.  The JAX
        package's name: it pads to the TPU's tiles, the port pads
        nothing."""
        op = self.op(dtype, transpose=transpose)
        n = self.shape[1] if transpose else self.shape[0]
        v = np.asarray(v, dtype=np.float64).reshape(-1)
        if v.size != n:
            raise DimensionMismatchError(f"vector length {v.size} != matrix dim {n}")
        return config.to_device(v, op.dtype, self.device)

    # ------------------------------------------------------------ host ops
    def matvec(self, x) -> np.ndarray:
        return self.csr.matvec(x)

    def to_dense(self) -> np.ndarray:
        return self.csr.to_dense()

    def to_dict(self, fmt: str = "coo") -> dict:
        n, m = self.shape
        if fmt == "dense":
            return {"rows": n, "cols": m, "data": self.to_dense().tolist(),
                    "format": "dense"}
        r, c, v = self.csr.to_coo()
        return {
            "rows": n,
            "cols": m,
            "values": v.tolist(),
            "rowIndices": r.tolist(),
            "colIndices": c.tolist(),
            "format": "coo",
        }

    def transpose(self) -> "Matrix":
        return Matrix(self.T_csr(), prefer=self._prefer, device=self.device)

    def diagonal_vector(self) -> np.ndarray:
        return self.csr.diagonal_vector()

    def dominance_gap(self) -> float:
        """alpha = min_i (|a_ii| - sum_{j!=i} |a_ij|); > 0 iff strictly row
        diagonally dominant.  1/alpha bounds ||A^-1||_inf (Varah), used for
        the deterministic ErrorBounds on solve results."""
        if self._dom_gap is None:
            n, m = self.shape
            if n != m or n == 0:
                self._dom_gap = 0.0
            else:
                d = np.abs(self.csr.diagonal_vector())
                off = self.csr.offdiag_abs_row_sums()
                self._dom_gap = float(np.min(d - off))
        return self._dom_gap
