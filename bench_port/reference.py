"""The plain reference: straightforward PyTorch on the benchmark's own COO
triplets, independent of the port (it imports nothing of it and takes
nothing the port made).

``Coo`` holds a matrix as (rows, cols, vals) on a device, in one dtype;
a product is a gather, a multiply and an ``index_add_`` into the rows, so
duplicate entries add up as they do when the port builds its CSR.  The
answers are checked in float64.  The same code in a lower dtype is the
control that a check has to fail (``control.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Coo:
    n: int
    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor

    @classmethod
    def of(cls, data, device, dtype=torch.float64) -> "Coo":
        return cls(data.n, torch.from_numpy(data.rows).to(device),
                   torch.from_numpy(data.cols).to(device),
                   torch.from_numpy(data.vals).to(device, dtype))

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """A x for x of shape (n,) or (n, k)."""
        v = self.vals if x.dim() == 1 else self.vals[:, None]
        out = torch.zeros((self.n,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        return out.index_add_(0, self.rows, v * x[self.cols])

    def transposed(self) -> "Coo":
        return Coo(self.n, self.cols, self.rows, self.vals)

    def split_diagonal(self) -> tuple[torch.Tensor, "Coo"]:
        """(the diagonal as a vector, the off-diagonal part)."""
        on = self.rows == self.cols
        d = torch.zeros(self.n, dtype=self.vals.dtype, device=self.vals.device)
        d.index_add_(0, self.rows[on], self.vals[on])
        off = ~on
        return d, Coo(self.n, self.rows[off], self.cols[off], self.vals[off])


def relative_residuals(A: Coo, X: np.ndarray, B: np.ndarray) -> np.ndarray:
    """||A x - b||_2 / ||b||_2 of each column (or of the one vector), in
    float64 on A's device."""
    dev = A.vals.device
    x = torch.from_numpy(np.asarray(X, dtype=np.float64)).to(dev)
    b = torch.from_numpy(np.asarray(B, dtype=np.float64)).to(dev)
    r = A.matvec(x) - b
    return (torch.linalg.vector_norm(r, dim=0)
            / torch.linalg.vector_norm(b, dim=0)).cpu().numpy()


def neumann(A: Coo, B: torch.Tensor, iterations: int) -> torch.Tensor:
    """x = sum_k (-D^-1 R)^k D^-1 b over ``iterations`` terms, in A's dtype,
    for b of shape (n,) or (n, k)."""
    d, off = A.split_diagonal()
    inv_d = (1.0 / d) if B.dim() == 1 else (1.0 / d)[:, None]
    term = inv_d * B
    x = term.clone()
    for _ in range(iterations):
        term = -inv_d * off.matvec(term)
        x = x + term
    return x


@dataclasses.dataclass
class Transition:
    """Column-stochastic P^T of an adjacency, with its dangling mask."""
    PT: Coo
    dangling: torch.Tensor

    @classmethod
    def of(cls, adjacency: Coo) -> "Transition":
        out = torch.zeros(adjacency.n, dtype=adjacency.vals.dtype,
                          device=adjacency.vals.device)
        out.index_add_(0, adjacency.rows, adjacency.vals)
        safe = torch.where(out > 0, out, torch.ones_like(out))
        P = Coo(adjacency.n, adjacency.rows, adjacency.cols,
                adjacency.vals / safe[adjacency.rows])
        return cls(P.transposed(), out == 0)


def pagerank(T: Transition, source: int, damping: float,
             tol: float = 1e-12, max_iterations: int = 1000,
             iterations: int | None = None) -> torch.Tensor:
    """Personalized PageRank from one source node by the power iteration
    x <- (1 - a) v + a (P^T x + dangling mass * v), from x = v, in T's
    dtype: until the l1 change is below ``tol``, or for exactly
    ``iterations`` steps when that is given.  Returns x / sum(x)."""
    vals = T.PT.vals
    v = torch.zeros(T.PT.n, dtype=vals.dtype, device=vals.device)
    v[source] = 1.0
    x = v
    steps = iterations if iterations is not None else max_iterations
    for _ in range(steps):
        mass = x[T.dangling].sum()
        x_new = (1 - damping) * v + damping * (T.PT.matvec(x) + mass * v)
        change = float((x_new - x).abs().sum()) if iterations is None else None
        x = x_new
        if change is not None and change < tol:
            break
    return x / x.sum()


def l1_error(x: np.ndarray, x_star: torch.Tensor) -> float:
    """||x - x*||_1 in float64 (both sum to 1, so this is relative)."""
    got = torch.from_numpy(np.asarray(x, dtype=np.float64)).to(x_star.device)
    return float((got - x_star.double()).abs().sum())
