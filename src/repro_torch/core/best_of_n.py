"""Best-of-N parallel test-time scaling (paper §2.1, Fig. 1 left): one
prefill per prompt, the paged KV forked N ways, all N samples decoding in
one batch (the rows a weight-bandwidth-bound decode leaves idle), the
scorer's argmax wins."""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.data import tasks as T
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.serving.engine import DecodeEngine
from repro_torch.serving.sampler import SamplerConfig


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


def sample_completions(engine: DecodeEngine, tok: ByteTokenizer,
                       task: T.MathTask, *, n: int, max_tokens: int,
                       generator: Optional[torch.Generator],
                       sc: SamplerConfig, prompt_len: int):
    """The direct path shared by Best-of-N and self-consistency: prefill
    the prompt once, fork it ``n`` ways, generate ``max_tokens`` and
    release the task's blocks (the direct path builds one throwaway
    state per task, so its blocks go back by hand).  Returns (final
    state, completions)."""
    ids, lens = tok.encode_batch([task.prompt], prompt_len)
    state = engine.prefill(torch.from_numpy(ids), torch.from_numpy(lens))
    state = engine.fork(state, n)
    state, out = engine.generate(state, max_tokens, generator, sc)
    engine.release_rows(state, list(range(n)))
    return state, [tok.decode(row) for row in out.tolist()]


def best_of_n(engine: DecodeEngine, tok: ByteTokenizer, task: T.MathTask,
              *, n: int, max_tokens: int,
              generator: Optional[torch.Generator], scorer,
              sc: SamplerConfig = SamplerConfig(temperature=0.8),
              prompt_len: int = 64) -> TTSResult:
    """Generate N samples of one task, pick the scorer's argmax."""
    state, completions = sample_completions(
        engine, tok, task, n=n, max_tokens=max_tokens, generator=generator,
        sc=sc, prompt_len=prompt_len)
    scores, chosen, ans, correct = select_best(
        task, completions, scorer, state.logprob_sum, state.n_gen)
    return TTSResult(completions=completions, scores=scores, chosen=chosen,
                     answer=ans, correct=correct,
                     decode_tokens=int(state.n_gen.sum()))


def evaluate_best_of_n(engine, tok, tasks: Sequence[T.MathTask], *, n: int,
                       max_tokens: int, generator: Optional[torch.Generator],
                       scorer,
                       sc: SamplerConfig = SamplerConfig(temperature=0.8)):
    """Accuracy and decode cost over a task set (one Fig. 10 point)."""
    correct = cost = 0
    for task in tasks:
        r = best_of_n(engine, tok, task, n=n, max_tokens=max_tokens,
                      generator=generator, scorer=scorer, sc=sc)
        correct += int(r.correct)
        cost += r.decode_tokens
    return {"accuracy": correct / max(1, len(tasks)),
            "decode_tokens": cost, "n": n}
