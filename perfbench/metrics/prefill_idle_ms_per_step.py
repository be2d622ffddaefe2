"""Scheduler admission's prefills (``DecodeEngine.prefill``): the time
inside the tracer's ``prefill`` spans of the profiled window, placed by
their own Unix stamps, in which no device activity ran, per profiled
step: the card starved while admission dispatches its prefills."""
from benchlib import devclock as DC

LAYER = "scheduler"
UNIT = "ms"
MOVES = "decode_tok_per_s"


def read(rec):
    return DC.idle_ms_per_step(rec, "prefill")
