"""Empirical complexity validation: fit O(n^k) models to timing data.

A copy of ``sublinear_tpu/utils/complexity.py`` (reference:
scripts/performance/complexity_validator.py:316-338, the least-squares fit
of log t = k log n + c, classified against claimed complexity classes).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class ComplexityFit:
    exponent: float
    coefficient: float
    r_squared: float
    classification: str


def fit_power_law(ns, times) -> ComplexityFit:
    ns = np.asarray(ns, dtype=np.float64)
    times = np.asarray(times, dtype=np.float64)
    mask = (ns > 0) & (times > 0)
    ns, times = ns[mask], times[mask]
    if ns.size < 2:
        return ComplexityFit(float("nan"), float("nan"), 0.0, "insufficient-data")
    lx, ly = np.log(ns), np.log(times)
    k, c = np.polyfit(lx, ly, 1)
    pred = k * lx + c
    ss_res = float(np.sum((ly - pred) ** 2))
    ss_tot = float(np.sum((ly - ly.mean()) ** 2))
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0
    return ComplexityFit(float(k), math.exp(c), r2, classify_exponent(float(k)))


def classify_exponent(k: float) -> str:
    if k < 0.2:
        return "O(1)/O(log n)"
    if k < 0.7:
        return "O(sqrt n)"
    if k < 1.3:
        return "O(n)"
    if k < 1.7:
        return "O(n^1.5)"
    if k < 2.3:
        return "O(n^2)"
    return f"O(n^{k:.1f})"


def validate_complexity(ns, times, claimed_exponent: float, tolerance: float = 0.35) -> dict:
    fit = fit_power_law(ns, times)
    return {
        "fit": dataclasses.asdict(fit),
        "claimedExponent": claimed_exponent,
        "withinTolerance": bool(abs(fit.exponent - claimed_exponent) <= tolerance),
    }
