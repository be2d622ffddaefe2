"""The sampler (``serving/sampler.sample`` and ``logprobs_of`` over the
step's f32 logits, with the stop and length bookkeeping, in
``DecodeEngine._step_core``): the card's time between the CUDA events
the tracer records at the ``sample`` span's ends (``device_s``), summed
over the window's spans, per window step."""
from benchlib import stats as ST

LAYER = "sampler"
UNIT = "ms"
MOVES = "decode_tok_per_s"


def read(rec):
    if rec["device"] is None or not rec["steps"]:
        return None
    spans = [s for s in ST.spans_in(rec["spans"], *rec["span_window"],
                                    "sample") if "device_s" in s.args]
    if not spans:
        return None
    return 1e3 * sum(s.args["device_s"] for s in spans) / len(rec["steps"])
