"""Accurate reductions, as in ``sublinear_tpu/ops/reductions.py``.

The JAX package recovers f32 accumulation accuracy on the TPU with
compensated (Neumaier) sums across blocks.  The H100 has f64, so here the
sums accumulate in f64 (a tensor of any floating dtype is summed in f64)
and are rounded once to the input's dtype: at least as accurate as the
compensated f32 sum, and one reduction kernel on the card.
"""
from __future__ import annotations

import torch


def _acc(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1).to(torch.float64)


def kahan_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of every entry of ``x``, accumulated in f64, as a 0-d tensor of
    ``x``'s dtype."""
    return _acc(x).sum().to(x.dtype)


def compensated_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b with the products and the sum in f64, in a's dtype."""
    return (_acc(a) * _acc(b)).sum().to(a.dtype)


def compensated_norm(v: torch.Tensor) -> torch.Tensor:
    """||v||_2 scaled by max |v| for overflow safety, the sum of squares in
    f64, in v's dtype."""
    w = _acc(v)
    m = torch.clamp(w.abs().max(), min=1e-30)
    return (m * torch.sqrt(((w / m) ** 2).sum())).to(v.dtype)
