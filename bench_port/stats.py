"""Spread of repeated runs, as the bounds in ``BENCHMARK.json`` are set
from it: the distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) as a share of the median."""
from __future__ import annotations

import statistics


def spread(values) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed(values) -> list:
    """``values`` without the one farthest from their median."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return [v for i, v in enumerate(values) if i != far]
