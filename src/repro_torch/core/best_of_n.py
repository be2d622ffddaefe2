"""Best-of-N parallel test-time scaling (paper §2.1, Fig. 1 left): one
prefill per prompt, N samples decoding in one batch, the scorer's argmax
wins."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.data import tasks as T


@dataclasses.dataclass
class TTSResult:
    completions: list          # list[str], length N
    scores: torch.Tensor
    chosen: int
    answer: Optional[int]
    correct: Optional[bool]
    decode_tokens: int         # total decode cost (batch-steps summed)


def select_best(task: T.MathTask, completions, scorer, logprob_sum, n_gen):
    """Scorer dispatch + argmax selection (first maximum on ties).
    Returns (scores, chosen, answer, correct)."""
    if hasattr(scorer, "score_texts"):
        scores = scorer.score_texts(task, completions)
    else:  # LogProbScorer
        scores = scorer.score_states(logprob_sum, n_gen)
    chosen = int(torch.argmax(scores))
    ans = T.extract_answer(completions[chosen])
    correct = (ans == task.answer) if ans is not None else False
    return scores, chosen, ans, correct
