"""Order statistics of a run's samples, and the spread of a set of runs."""

from __future__ import annotations

import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of `values`, linear between the two
    nearest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError('percentile of no values')
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles as a share of
    the median, quartiles as `statistics.quantiles(values, n=4)` gives
    them."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(statistics.median(values))


def union_length(spans) -> float:
    """Total length covered by the (start, end) intervals `spans`: time in
    which at least one of them runs (a frozen copy of the port's
    `profile_step.union_length`)."""
    total, reach = 0.0, float('-inf')
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total
