"""Model step (``DecodeEngine._capture``): the host time of every
``capture`` span over the whole run, set-up included (the capture lands
in the warm-up), the cost of capturing the decode forward's CUDA graph.
A run with no capture reads nothing."""
LAYER = "model step"
UNIT = "ms"
MOVES = "setup_s"


def read(rec):
    spans = [s for s in rec["spans"] if s.name == "capture"]
    if not spans:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in spans)
