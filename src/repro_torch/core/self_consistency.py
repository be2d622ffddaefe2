"""Self-consistency / majority voting (paper §2.1): verifier-free TTS.

N samples decode in one batch as in Best-of-N; the most frequent
extracted answer wins, ties going to the answer counted first."""
from __future__ import annotations

from collections import Counter
from typing import Optional

import torch

from repro_torch.core.best_of_n import TTSResult, sample_completions
from repro_torch.data import tasks as T
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.serving.engine import DecodeEngine
from repro_torch.serving.sampler import SamplerConfig


def majority_vote(task: T.MathTask, completions: list) -> tuple:
    """(scores, chosen, answer, correct) of a vote over ``completions``:
    each completion scores its answer's vote count (0 without one),
    ``chosen`` is the first completion carrying the winning answer (0 when
    none has an answer)."""
    answers = [T.extract_answer(c) for c in completions]
    votes = Counter(a for a in answers if a is not None)
    ans = votes.most_common(1)[0][0] if votes else None
    chosen = answers.index(ans) if ans is not None else 0
    scores = torch.tensor([votes.get(a, 0) if a is not None else 0
                           for a in answers], dtype=torch.float32)
    correct = (ans == task.answer) if ans is not None else False
    return scores, chosen, ans, correct


def self_consistency(engine: DecodeEngine, tok: ByteTokenizer,
                     task: T.MathTask, *, n: int, max_tokens: int,
                     generator: Optional[torch.Generator],
                     sc: SamplerConfig = SamplerConfig(temperature=0.8),
                     prompt_len: int = 64) -> TTSResult:
    state, completions = sample_completions(
        engine, tok, task, n=n, max_tokens=max_tokens, generator=generator,
        sc=sc, prompt_len=prompt_len)
    scores, chosen, ans, correct = majority_vote(task, completions)
    return TTSResult(completions=completions, scores=scores, chosen=chosen,
                     answer=ans, correct=correct,
                     decode_tokens=int(state.n_gen.sum()))
