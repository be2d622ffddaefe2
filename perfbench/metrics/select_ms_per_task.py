"""Task selection (``core/best_of_n.select_best`` under
``core/reward.LogProbScorer``, with the completions' decoding): the
harness's timer around it, per task completed in the window."""
LAYER = "task selection"
UNIT = "ms"
MOVES = "task_p90_s"


def read(rec):
    done = rec["done"]
    if not done:
        return None
    return 1e3 * sum(r.select_s for r in done) / len(done)
