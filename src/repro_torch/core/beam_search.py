"""Step-level beam search with a process reward model (paper §2.1, Fig. 1
right; Snell et al. 2024), the direct path.

Beams decode in one batch (width × expand) and, like Best-of-N, ride the
idle rows of the decode batch.  After every reasoning step (delimiter
'.'), each candidate prefix is scored by the PRM in one batched call; the
top ``width`` of ``width × expand`` survive (``engine.reorder`` gathers
their block tables) and are re-expanded.  The scheduler's beam request
class (``serving.engine.BeamSpec``) serves the same search inside the
continuous batch.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.best_of_n import TTSResult
from repro_torch.core.reward import prm_final_scores, prm_step_scores
from repro_torch.data import tasks as T
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.serving.engine import DecodeEngine
from repro_torch.serving.sampler import SamplerConfig


def beam_search(engine: DecodeEngine, tok: ByteTokenizer, task: T.MathTask,
                *, width: int, expand: int, max_steps: int = 8,
                step_tokens: int = 16, generator: Optional[torch.Generator],
                prm, sc: SamplerConfig = SamplerConfig(temperature=0.8),
                prompt_len: int = 64) -> TTSResult:
    """width = surviving beams; expand = candidates per beam per step.

    Every pool block the search holds is released on return — normal
    exit, early answer, or an exception mid-search (``fork``, ``reorder``
    and ``prepare_decode`` leave the pool untouched when they raise, so
    the live ``state`` always accounts for every held block)."""
    dot_id = tok.encode(".", bos=False)[0]
    ids, lens = tok.encode_batch([task.prompt], prompt_len)
    state = engine.prefill(torch.from_numpy(ids), torch.from_numpy(lens))
    try:
        state = engine.fork(state, width)
        beams = [[] for _ in range(width)]   # generated ids per beam
        total_tokens = 0
        for _ in range(max_steps):
            state = engine.fork(state, expand)
            beams = [list(b) for b in beams for _ in range(expand)]
            state = engine.resume(state)
            state, out = engine.generate(state, step_tokens, generator, sc,
                                         stop_ids=(engine.eos_id, dot_id))
            out = out.tolist()
            total_tokens += sum(t != engine.pad_id for row in out
                                for t in row)
            for b, row in zip(beams, out):
                b.extend(t for t in row if t != engine.pad_id)
            # decode each candidate's full id list, so multi-byte UTF-8
            # never splits at a step boundary ('.' stays in the text)
            texts = [tok.decode(b) for b in beams]
            scores = torch.as_tensor(prm_step_scores(
                prm, task, texts, state.logprob_sum, state.n_gen))
            # stable: ties keep the lowest candidate, as the scheduler does
            keep = torch.argsort(-scores.cpu(), stable=True)[:width]
            keep = keep.numpy().astype(np.int64)
            state = engine.reorder(state, keep)
            beams = [beams[int(i)] for i in keep]
            texts = [texts[int(i)] for i in keep]
            if all("A:" in t for t in texts):
                break
        final_scores = prm_final_scores(prm, task, texts, state.logprob_sum,
                                        state.n_gen)
        chosen = int(torch.argmax(torch.as_tensor(final_scores)))
    finally:
        state = engine.release_rows(state,
                                    list(range(int(state.done.shape[0]))))
    ans = T.extract_answer(texts[chosen])
    return TTSResult(
        completions=texts, scores=final_scores, chosen=chosen, answer=ans,
        correct=(ans == task.answer) if ans is not None else False,
        decode_tokens=total_tokens)
