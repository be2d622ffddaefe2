"""Model step (``DecodeEngine._step_core``'s forward): the share of the
window's ``forward`` spans whose ``graph`` arg is true, the decode
forwards replayed from the engine's CUDA graph rather than dispatched op
by op.  A program whose spans carry no ``graph`` arg reads nothing, nor
does a run without the card's trace (no graph off the card)."""
from benchlib import stats as ST

LAYER = "model step"
UNIT = "%"
MOVES = "decode_tok_per_s"


def read(rec):
    if rec["device"] is None:
        return None
    spans = [s for s in ST.spans_in(rec["spans"], *rec["span_window"],
                                    "forward") if "graph" in s.args]
    if not spans:
        return None
    return 100.0 * sum(bool(s.args["graph"]) for s in spans) / len(spans)
