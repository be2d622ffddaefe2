"""The device: the share of the traced window in which no kernel, copy
or set ran on it (``torch.profiler``'s device activities, merged)."""
from benchlib import devtrace as DT

LAYER = "device"
UNIT = "%"
MOVES = "decode_tok_per_s"


def read(rec):
    dev = rec["device"]
    if dev is None or dev.window_s <= 0 or not dev.ops:
        return None
    return 100.0 * (1.0 - DT.busy_s(dev.ops) / dev.window_s)
