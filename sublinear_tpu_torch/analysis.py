"""Matrix analysis — diagonal dominance, symmetry, sparsity, bandwidth,
condition estimate, method recommendation.

A copy of ``sublinear_tpu/analysis.py`` (pure NumPy over the host CSR).

Parity with the reference's analyzers:
  - TS ``MatrixOperations.analyzeMatrix`` (src/core/matrix.ts:211-354)
  - MCP ``MatrixTools.analyzeMatrix`` extras — bandwidth/profile/complexity
    prediction/memory estimate/recommendation
    (src/mcp/tools/matrix.ts:20-295)
  - Rust sparsity/conditioning info (src/matrix/mod.rs:25-104)

Everything here is vectorized host-side NumPy over the CSR — analysis is a
one-shot O(nnz) pass, not a hot path.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from .matrix import Matrix


@dataclasses.dataclass
class MatrixAnalysis:
    is_diagonally_dominant: bool
    dominance_type: str          # 'row' | 'column' | 'none'
    dominance_strength: float
    is_symmetric: bool
    sparsity: float              # fraction of zero entries, matching TS semantics
    size: tuple
    nnz: int
    bandwidth: int
    spectral_radius_estimate: Optional[float] = None
    condition_estimate: Optional[float] = None
    p_norm_gap: Optional[float] = None
    min_diagonal: float = 0.0
    max_diagonal: float = 0.0
    avg_row_nnz: float = 0.0
    max_row_nnz: int = 0
    recommended_method: str = "conjugate-gradient"
    complexity_estimate: str = ""
    memory_estimate: str = ""

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        # camelCase aliases for MCP/CLI parity with the TS schema
        d.update(
            isDiagonallyDominant=self.is_diagonally_dominant,
            dominanceType=self.dominance_type,
            dominanceStrength=self.dominance_strength,
            isSymmetric=self.is_symmetric,
            size={"rows": self.size[0], "cols": self.size[1]},
            recommendedMethod=self.recommended_method,
        )
        return d


def analyze(matrix: Matrix, estimate_condition: bool = True) -> MatrixAnalysis:
    cached = getattr(matrix, "_analysis_cache", None)
    if cached is not None and (cached.condition_estimate is not None or not estimate_condition):
        return cached
    csr = matrix.csr
    n, m = csr.shape
    diag = csr.diagonal_vector()
    abs_diag = np.abs(diag)

    row_off = csr.offdiag_abs_row_sums()[: min(n, m)] if n else np.zeros(0)
    col_off = csr.offdiag_abs_col_sums()[: min(n, m)] if m else np.zeros(0)

    # a zero diagonal entry disqualifies dominance (the solvers need D^-1)
    nonzero_diag = bool(abs_diag.size and np.all(abs_diag > 0))
    row_dom = bool(n == m and n > 0 and nonzero_diag
                   and np.all(abs_diag >= row_off - 1e-12 * np.maximum(abs_diag, 1)))
    col_dom = bool(n == m and n > 0 and nonzero_diag
                   and np.all(abs_diag >= col_off - 1e-12 * np.maximum(abs_diag, 1)))

    # dominance strength: min over rows of (|a_ii| - offsum)/|a_ii|
    # (reference: src/core/matrix.ts:211-262 checkDiagonalDominance)
    with np.errstate(divide="ignore", invalid="ignore"):
        strengths = np.where(abs_diag > 0, (abs_diag - row_off) / np.where(abs_diag > 0, abs_diag, 1), -np.inf)
    strength = float(np.min(strengths)) if strengths.size else 0.0

    dominance_type = "row" if row_dom else ("column" if col_dom else "none")

    sparsity = 1.0 - csr.nnz / max(n * m, 1)
    row_nnz = csr.row_nnz()

    # spectral radius of the Jacobi iteration matrix D^-1 R, estimated by the
    # max row ratio (exact bound for DD matrices; reference:
    # src/matrix/mod.rs spectral_radius_estimate)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratios = np.where(abs_diag > 0, row_off / np.where(abs_diag > 0, abs_diag, 1), np.inf)
    rho = float(np.max(ratios)) if ratios.size else 0.0

    cond = None
    if estimate_condition and n == m and n > 0 and np.all(abs_diag > 0):
        # Gershgorin-based bound: eigenvalues lie in [min(|d|-off), max(|d|+off)]
        lo = float(np.min(abs_diag - row_off))
        hi = float(np.max(abs_diag + row_off))
        cond = hi / lo if lo > 0 else float("inf")

    p_norm_gap = max(0.0, 1.0 - rho) if n == m else None

    analysis = MatrixAnalysis(
        is_diagonally_dominant=row_dom or col_dom,
        dominance_type=dominance_type,
        dominance_strength=strength,
        is_symmetric=csr.is_symmetric() if n == m else False,
        sparsity=sparsity,
        size=(n, m),
        nnz=csr.nnz,
        bandwidth=csr.bandwidth(),
        spectral_radius_estimate=rho,
        condition_estimate=cond,
        p_norm_gap=p_norm_gap,
        min_diagonal=float(abs_diag.min()) if abs_diag.size else 0.0,
        max_diagonal=float(abs_diag.max()) if abs_diag.size else 0.0,
        avg_row_nnz=float(row_nnz.mean()) if row_nnz.size else 0.0,
        max_row_nnz=int(row_nnz.max()) if row_nnz.size else 0,
    )
    analysis.recommended_method = _recommend(analysis)
    analysis.complexity_estimate = _complexity(analysis)
    analysis.memory_estimate = _memory(analysis)
    matrix._analysis_cache = analysis
    return analysis


def _recommend(a: MatrixAnalysis) -> str:
    """Method recommendation mirroring
    the reference's src/mcp/tools/matrix.ts recommendSolverMethod and the
    BMSSP classifier src/bmssp.rs:205-219."""
    n = a.size[0]
    if not a.is_diagonally_dominant:
        return "conjugate-gradient" if a.is_symmetric else "bmssp"
    if a.is_symmetric:
        return "conjugate-gradient" if a.dominance_strength < 0.3 else "neumann"
    if a.dominance_strength > 0.3:
        return "neumann"
    return "forward-push"


def _complexity(a: MatrixAnalysis) -> str:
    n = max(a.size[0], 1)
    nnz = a.nnz
    if a.is_diagonally_dominant:
        if a.dominance_strength > 0.5:
            return f"O(nnz * log n) ~ O({nnz} * {math.ceil(math.log2(max(n, 2)))})"
        return f"O(nnz * sqrt(n)) ~ O({nnz} * {math.ceil(math.sqrt(n))})"
    return f"O(n^3) ~ O({n}^3) - not suitable for sublinear methods"


def _memory(a: MatrixAnalysis) -> str:
    n, m = a.size
    if a.sparsity < 0.5:
        mb = n * m * 4 / 1024 / 1024
        return f"{mb:.1f} MB (dense f32)"
    mb = a.nnz * (4 + 4) * 2 / 1024 / 1024
    return f"{mb:.1f} MB (ELL f32 + indices)"
