"""Prefix cache (``serving/prefix_cache.PrefixCache``): the prompt tokens
whose prefill the cache saved, over the prompt tokens of the requests
admitted in the window (``SchedulerMetrics.prefill_tokens_saved``)."""
LAYER = "prefix cache"
UNIT = "%"
MOVES = "task_p90_s"


def read(rec):
    if not rec["prefix_cache"] or not rec["admitted_prompt_tokens"]:
        return None
    return 100.0 * rec["saved_in_window"] / rec["admitted_prompt_tokens"]
