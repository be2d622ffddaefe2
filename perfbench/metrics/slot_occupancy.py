"""Scheduler: the share of slot-steps that decoded a row in the window
(``StepRecord.occupancy`` over the slots)."""
LAYER = "scheduler"
UNIT = "%"
MOVES = "decode_tok_per_s"


def read(rec):
    steps = rec["steps"]
    if not steps:
        return None
    return 100.0 * sum(s.occupancy for s in steps) / (len(steps)
                                                      * rec["n_slots"])
