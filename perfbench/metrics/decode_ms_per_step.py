"""Model step (``models/transformer.decode_step`` and the sampler through
``DecodeEngine._step_core``): the tracer's ``decode`` spans less the
``plan`` spans inside them, per step of the window.  The span closes
after the tokens' copy to the host, so it holds the device's time too."""
from benchlib import stats as ST

LAYER = "model step"
UNIT = "ms"
MOVES = "decode_tok_per_s"


def read(rec):
    if not rec["steps"]:
        return None
    return 1e3 * ST.self_time(rec["spans"], *rec["span_window"], "decode",
                              "plan") / len(rec["steps"])
