"""Host spans placed on the device trace's clock by their own Unix
stamps (``Span.u0`` / ``u1``, seconds), and the card's idle time inside
them."""
from __future__ import annotations

import bisect

from benchlib import devtrace as DT


def profiled_spans(spans, dev, name: str) -> list:
    """The ``name`` spans that carry Unix stamps and lie inside the
    profiled window (from the wall-clock read at the profiler's start,
    for the window's seconds); a program whose spans have no stamps
    gives none."""
    lo, hi = dev.unix_t0, dev.unix_t0 + dev.window_s
    return [s for s in spans if s.name == name
            and getattr(s, "u0", None) is not None
            and lo <= s.u0 and s.u1 <= hi]


def idle_s(spans, ops) -> float:
    """Seconds inside ``spans`` (each [u0, u1]) in which no device
    activity of ``ops`` (name, start, dur) ran."""
    iv = DT.union(ops)
    ends = [e for _, e in iv]
    total = 0.0
    for sp in spans:
        busy = 0.0
        i = bisect.bisect_right(ends, sp.u0)
        while i < len(iv) and iv[i][0] < sp.u1:
            busy += min(iv[i][1], sp.u1) - max(iv[i][0], sp.u0)
            i += 1
        total += (sp.u1 - sp.u0) - busy
    return total


def idle_ms_per_step(rec, name: str):
    """The card's idle ms inside the profiled window's ``name`` spans,
    per profiled step; None without a device trace or such spans."""
    dev = rec["device"]
    if dev is None or not dev.ops or dev.step1 <= dev.step0:
        return None
    spans = profiled_spans(rec["spans"], dev, name)
    if not spans:
        return None
    return 1e3 * idle_s(spans, dev.ops) / (dev.step1 - dev.step0)
