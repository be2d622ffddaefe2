"""Model step, the step's end (``ContinuousScheduler.step_once``'s
copies of the tokens, done flags, logprobs and counts to the host): the
host time of the tracer's ``readback`` spans in the window, per window
step: the host blocked on the card's rest of the step."""
from benchlib import stats as ST

LAYER = "model step"
UNIT = "ms"
MOVES = "decode_tok_per_s"


def read(rec):
    if rec["device"] is None or not rec["steps"]:
        return None
    spans = ST.spans_in(rec["spans"], *rec["span_window"], "readback")
    if not spans:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in spans) / len(rec["steps"])
