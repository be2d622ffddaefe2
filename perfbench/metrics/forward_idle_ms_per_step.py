"""Model step (``models/transformer.decode_step`` through
``DecodeEngine._decode``): the time inside the tracer's ``forward``
spans of the profiled window, placed by their own Unix stamps, in which
no device activity ran, per profiled step: the card starved by the
host's dispatch of the forward."""
from benchlib import devclock as DC

LAYER = "model step"
UNIT = "ms"
MOVES = "decode_tok_per_s"


def read(rec):
    return DC.idle_ms_per_step(rec, "forward")
