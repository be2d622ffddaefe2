"""Budget controller: continuous Best-of-N serving over a task set and the
accuracy/cost sweep behind the paper's Pareto plots (Fig. 10).

Every task is one TTS request routed through one
:class:`~repro_torch.serving.engine.ContinuousScheduler` slot pool, so
all tasks' samples share the decode batch and slots refill mid-flight.
Serving rows carry ``SchedulerMetrics.summary()`` under ``"serving"``
plus the paged pool's accounting under ``"serving"]["kv"]``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.core import best_of_n as BoN
from repro_torch.data import tasks as T
from repro_torch.serving.engine import ContinuousScheduler, Request
from repro_torch.serving.kv_pool import dense_kv_bytes
from repro_torch.serving.sampler import SamplerConfig


@dataclasses.dataclass
class TTSSpec:
    method: str            # "best_of_n" (the port's only method so far)
    budget: int            # N parallel samples
    max_tokens: int = 48


def serve_best_of_n(engine, tok, tasks: Sequence[T.MathTask], *, n: int,
                    max_tokens: int, rng: Optional[torch.Generator], scorer,
                    n_slots: int = 8, prompt_len: Optional[int] = None,
                    sc: SamplerConfig = SamplerConfig(temperature=0.8)):
    """Best-of-N over a task set through the continuous-batching
    scheduler: one prefill per task, ``fork`` into ``n`` slots.
    ``prompt_len`` defaults to the longest prompt.  Returns {"method",
    "budget", "accuracy", "decode_tokens", "serving"}."""
    prompts = [torch.tensor(tok.encode(task.prompt), dtype=torch.int32)
               for task in tasks]
    if prompt_len is None:
        prompt_len = max((int(p.shape[0]) for p in prompts), default=1)
    sched = ContinuousScheduler(engine, n_slots=n_slots,
                                prompt_len=prompt_len)
    # the pool's peak/CoW counters are lifetime values on a shared engine;
    # rebase them so this row reports its own interval
    cow_base = engine.pool.reset_peak()
    for i, prompt in enumerate(prompts):
        sched.submit(Request(req_id=i, prompt=prompt,
                             max_new_tokens=max_tokens, n_samples=n))
    sched.run(rng, sc)
    serving = sched.metrics.summary()
    kv = engine.pool.stats()
    kv["cow_copies"] -= cow_base
    kv["dense_bytes"] = dense_kv_bytes(engine.cfg, n_slots, engine.max_len)
    kv["hbm_saved_bytes"] = kv["dense_bytes"] - kv["peak_bytes_in_use"]
    serving["kv"] = kv
    correct = cost = 0
    for i, task in enumerate(tasks):
        samples = sorted(sched.completed[i], key=lambda s: s.sample_idx)
        completions = [tok.decode(s.tokens) for s in samples]
        cost += sum(s.n_gen for s in samples)
        _, _, _, ok = BoN.select_best(
            task, completions, scorer,
            torch.tensor([s.logprob_sum for s in samples]),
            torch.tensor([s.n_gen for s in samples], dtype=torch.int32))
        correct += int(ok)
    return {
        "method": "best_of_n",
        "budget": n,
        "accuracy": correct / max(1, len(tasks)),
        "decode_tokens": cost,
        "serving": serving,
    }


def sweep(engine, tok, tasks: Sequence[T.MathTask], specs: Sequence[TTSSpec],
          rng: Optional[torch.Generator], scorer, *, n_slots: int = 8,
          sc: Optional[SamplerConfig] = None):
    """Accuracy / decode cost for each spec — one row per Pareto point —
    through continuous Best-of-N serving (the scheduler grows to
    ``max(n_slots, budget)`` slots)."""
    sc_kwargs = {} if sc is None else {"sc": sc}
    rows = []
    for spec in specs:
        if spec.method != "best_of_n":
            raise ValueError(f"the port serves best_of_n only, got "
                             f"{spec.method!r}")
        rows.append(serve_best_of_n(
            engine, tok, tasks, n=spec.budget, max_tokens=spec.max_tokens,
            rng=rng, scorer=scorer, n_slots=max(n_slots, spec.budget),
            **sc_kwargs))
    return rows
