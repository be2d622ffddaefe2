"""Engine planning (``DecodeEngine.prepare_decode``: the host's block
allocation and copy-on-write plan): the tracer's ``plan`` spans in the
window, per step."""
from benchlib import stats as ST

LAYER = "engine planning"
UNIT = "ms"
MOVES = "decode_tok_per_s"


def read(rec):
    if not rec["steps"]:
        return None
    spans = ST.spans_in(rec["spans"], *rec["span_window"], "plan")
    return 1e3 * sum(s.t1 - s.t0 for s in spans) / len(rec["steps"])
