"""Scheduler admission (``ContinuousScheduler._admit``, its prefills
included): the tracer's ``admit`` spans in the window, per step."""
from benchlib import stats as ST

LAYER = "scheduler"
UNIT = "ms"
MOVES = "decode_tok_per_s"


def read(rec):
    if not rec["steps"]:
        return None
    spans = ST.spans_in(rec["spans"], *rec["span_window"], "admit")
    return 1e3 * sum(s.t1 - s.t0 for s in spans) / len(rec["steps"])
