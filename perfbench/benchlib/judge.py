"""What decides ``correct``: the served tokens against the plain reference.

After the window, a sample drawn from the seed of the tasks that finished
in it, the longest among them, one sample each.  The reference runs each
prompt with its served tokens once.  Sampling is a Gumbel-max draw
(``serving/sampler.sample``) from the loop's own generator, whose state
the loop kept before every step, so the reference draws the same noise
again: a served token is the argmax of logits / T + g, and the numbers
compared are the widest gap by which a served token's score lies below
the reference's best score at its position, and that gap's mean over
every token judged.  A sound run reads only the rounding of bf16 against
f32 there, at near-ties.

The control stands in for the program: the reference computed one
precision below the configuration's (``reference.BELOW``) over the same
sequences, its first choice at each position judged as a served token.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from benchlib import traffic as TR

JUDGE_SALT = 0x9E3779B9


@dataclass
class Judged:
    run: object          # loop.TaskRun
    idx: int             # sample index
    row: int             # slot row it decoded in
    cached: int          # prompt tokens served from the prefix cache


def choose(done: list, rows: dict, mix: dict, seed: int, n_tasks: int):
    """The longest finished task and ``n_tasks - 1`` others drawn from the
    seed, one sample of each."""
    if not done:
        return []
    rng = np.random.default_rng(int(seed) ^ JUDGE_SALT)
    order = sorted(done, key=lambda r: r.task.index)
    longest = max(order, key=lambda r: (max(len(s[0]) for s in
                                            r.samples.values()),
                                        -r.task.index))
    rest = [r for r in order if r is not longest]
    k = min(n_tasks - 1, len(rest))
    picks = [longest] + [rest[i] for i in sorted(
        rng.choice(len(rest), size=k, replace=False))] if k else [longest]
    out = []
    for r in picks:
        idx = (max(r.samples, key=lambda i: (len(r.samples[i][0]), -i))
               if r is longest else int(rng.integers(len(r.samples))))
        # a sample released in the step that admitted it (a stop id as
        # its first token) left no row behind, and served nothing
        row = rows.get((r.task.index, idx), -1)
        if row < 0 and r.samples[idx][0]:
            raise RuntimeError(f"no slot row recorded for task "
                               f"{r.task.index} sample {idx}")
        out.append(Judged(run=r, idx=idx, row=row,
                          cached=TR.cached_tokens(r.task, mix)))
    return out


def gumbel(states: dict, need: dict, shape: tuple, device) -> dict:
    """{(step, row): the Gumbel noise (V,) the sampler drew for that row
    at that step}, drawn again from the generator's saved states."""
    gen = torch.Generator(device=device)
    out = {}
    for step in sorted(need):
        gen.set_state(states[step])
        u = torch.rand(shape, generator=gen, device=device)
        rows = sorted(set(need[step]))
        g = -torch.log(-torch.log(u[rows].clamp(1e-20, 1.0)))
        for r, gr in zip(rows, g):
            out[step, r] = gr
        del u
    return out


def gaps(ref, w: dict, model: dict, judged: list, states: dict,
         n_slots: int, temperature: float, device, control=None) -> dict:
    """The widest gap of the judged tokens (``gap_max``), their mean gap
    (``gap_mean``) and how many were judged.  The judged tokens are the
    served ones, or with ``control`` (an activation rounding) the
    control's first choices at the same positions."""
    need: dict = {}
    for j in judged:
        fd = j.run.samples[j.idx][3]
        n = len(j.run.samples[j.idx][0])
        for t in range(n):
            need.setdefault(fd + t, []).append(j.row)
    noise = gumbel(states, need, (n_slots, model["vocab_size"]), device)
    worst = total = 0.0
    count = 0
    for j in judged:
        toks, _, _, fd, _ = j.run.samples[j.idx]
        n = len(toks)
        if n == 0:
            continue
        prompt = j.run.task.prompt
        P = len(prompt)
        seq = torch.as_tensor(np.concatenate(
            [prompt, np.asarray(toks[:-1], np.int32)]), device=device)
        rows = list(range(P - 1, P - 1 + n))
        g = torch.stack([noise[fd + t, j.row] for t in range(n)])
        score = ref.sequence_logits(w, model, seq, P, j.cached,
                                    rows) / temperature + g
        if control is None:
            picked = torch.as_tensor(toks, device=device, dtype=torch.long)
        else:
            picked = (ref.sequence_logits(w, model, seq, P, j.cached, rows,
                                          act=control) / temperature
                      + g).argmax(dim=-1)
        gap = score.max(dim=-1).values - score.gather(
            1, picked[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
        total += float(gap.sum())
        count += n
    return {"gap_max": worst, "gap_mean": total / max(count, 1),
            "judged_tokens": count}
