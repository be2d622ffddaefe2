"""The arithmetic of the end-to-end metrics and of the host spans."""
from __future__ import annotations


def percentile(xs, q: float) -> float:
    """Linear interpolation between closest ranks (numpy's default)."""
    xs = sorted(xs)
    if not xs:
        raise ValueError("percentile of nothing")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def window_rate(steps, t0: float, t1: float) -> float:
    """Tokens committed by every row over the window's seconds: each
    occupied row commits one token a plain step."""
    return sum(s.occupancy for s in steps) / (t1 - t0)


def task_latencies(done, open_ages) -> list:
    """Every task that completed in the window, submission to the end of
    its selection, and every task still running at its end, at its age
    then: a stall shows in the tail."""
    return [r.t_done - r.t_submit for r in done] + list(open_ages)


def spans_in(spans, t0: float, t1: float, name: str) -> list:
    """The ``name`` spans that lie within [t0, t1]."""
    return [s for s in spans if s.name == name and t0 <= s.t0 and s.t1 <= t1]


def self_time(spans, t0: float, t1: float, name: str, child: str) -> float:
    """Total time of the ``name`` spans in [t0, t1] less the part their
    ``child`` spans cover."""
    parents = spans_in(spans, t0, t1, name)
    kids = spans_in(spans, t0, t1, child)
    total = sum(p.t1 - p.t0 for p in parents)
    for p in parents:
        for k in kids:
            lo, hi = max(p.t0, k.t0), min(p.t1, k.t1)
            if hi > lo:
                total -= hi - lo
    return total
