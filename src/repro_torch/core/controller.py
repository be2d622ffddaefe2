"""Budget controller: maps a compute budget to a TTS configuration and
runs the accuracy/cost sweep behind the paper's Pareto plots (Fig. 10).

Two serving paths:

* the direct path (``run_method``) builds one decode batch per task —
  prefill, fork, generate to completion — for Best-of-N,
  self-consistency and beam search;
* the continuous path (``serve_best_of_n`` / ``serve_beam_search`` /
  ``sweep(continuous=True)``) routes every task through one
  :class:`~repro_torch.serving.engine.ContinuousScheduler` slot pool, so
  all tasks' samples (or beam lanes) share the decode batch and slots
  refill mid-flight.

Serving rows carry ``SchedulerMetrics.summary()`` under ``"serving"``
(with the beam counters ``beam_boundaries``, ``beam_expansions``,
``beam_prunes``, ``prm_batches``, ``prm_candidates`` and
``prm_candidates_per_batch``, and the speculative counters
``spec_rounds``, ``draft_tokens``, ``spec_acceptance_rate`` and
``accepted_tokens_per_step``) plus, on a paged engine, the pool's
accounting under ``"serving"]["kv"]`` and, with a prefix cache, the
cache's interval stats under ``"serving"]["prefix_cache"]``.  The summary's latency percentiles
(``ttft_*``, ``itl_*``, ``queue_wait_*``) need a ``tracer=``, its
profiler keys (``kernel_time_share``, ``roofline_efficiency_p50``,
``canary_*``) a ``profiler=``; without them they are 0.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import beam_search as BS
from repro_torch.core import best_of_n as BoN
from repro_torch.core import reward as R
from repro_torch.core import self_consistency as SC
from repro_torch.data import tasks as T
from repro_torch.serving.engine import (BeamSpec, ContinuousScheduler,
                                        Request, SpecConfig)
from repro_torch.serving.kv_pool import dense_kv_bytes
from repro_torch.serving.sampler import SamplerConfig


@dataclasses.dataclass
class TTSSpec:
    method: str            # "best_of_n" | "self_consistency" | "beam_search"
    budget: int            # N (parallel samples) or width * expand
    max_tokens: int = 48
    beam_width: int = 0    # beam search only (0: budget // 2)
    beam_expand: int = 0   # beam search only (0: 2)
    beam_steps: int = 8    # scoring boundaries (beam search only)
    step_tokens: int = 16  # token budget per reasoning step

    def beam_shape(self) -> tuple:
        """(width, expand) of a beam-search spec."""
        return (self.beam_width or max(1, self.budget // 2),
                self.beam_expand or 2)


def run_method(engine, tok, task, spec: TTSSpec,
               generator: Optional[torch.Generator], scorer):
    """One task through the direct path of ``spec.method``, with that
    method's default sampler."""
    if spec.method == "best_of_n":
        return BoN.best_of_n(engine, tok, task, n=spec.budget,
                             max_tokens=spec.max_tokens,
                             generator=generator, scorer=scorer)
    if spec.method == "self_consistency":
        return SC.self_consistency(engine, tok, task, n=spec.budget,
                                   max_tokens=spec.max_tokens,
                                   generator=generator)
    if spec.method == "beam_search":
        width, expand = spec.beam_shape()
        return BS.beam_search(engine, tok, task, width=width, expand=expand,
                              max_steps=spec.beam_steps,
                              step_tokens=spec.step_tokens,
                              generator=generator, prm=scorer)
    raise ValueError(f"unknown TTS method {spec.method!r}")


def _attach_serving_stats(serving: dict, engine, n_slots: int,
                          cow_base: int, prefix_cache, cache_base) -> None:
    """Attach the pool's (paged engines) and the prefix cache's interval
    stats to a serving row.  Their counters are lifetime values on an
    engine and a cache a whole sweep shares, so they are rebased to this
    row's interval (cached_blocks/bytes stay gauges)."""
    if engine.paged:
        kv = engine.pool.stats()
        kv["cow_copies"] -= cow_base
        kv["dense_bytes"] = dense_kv_bytes(engine.cfg, n_slots,
                                           engine.max_len)
        kv["hbm_saved_bytes"] = kv["dense_bytes"] - kv["peak_bytes_in_use"]
        serving["kv"] = kv
    if prefix_cache is not None:
        pc = prefix_cache.stats()
        for key in ("lookups", "hits", "tokens_matched", "insertions",
                    "evictions"):
            pc[key] -= cache_base[key]
        pc["hit_rate"] = pc["hits"] / pc["lookups"] if pc["lookups"] else 0.0
        serving["prefix_cache"] = pc


def serve_best_of_n(engine, tok, tasks: Sequence[T.MathTask], *, n: int,
                    max_tokens: int, rng: Optional[torch.Generator], scorer,
                    n_slots: int = 8, prompt_len: Optional[int] = None,
                    sc: SamplerConfig = SamplerConfig(temperature=0.8),
                    prefix_cache=None, tracer=None, profiler=None,
                    spec: Optional[SpecConfig] = None):
    """Best-of-N over a task set through the continuous-batching
    scheduler: one prefill per task, ``fork`` into ``n`` slots.
    ``prompt_len`` defaults to the longest prompt.  ``prefix_cache``: a
    :class:`~repro_torch.serving.prefix_cache.PrefixCache` over the
    engine's pool; tasks sharing a header then skip re-prefilling it.
    ``tracer`` / ``profiler``: the scheduler's telemetry and kernel
    profiler (None: off).  ``spec``: speculative rounds (under greedy
    ``sc``).  Returns {"method", "budget", "accuracy", "decode_tokens",
    "serving"}."""
    prompts = [torch.tensor(tok.encode(task.prompt), dtype=torch.int32)
               for task in tasks]
    if prompt_len is None:
        prompt_len = max((int(p.shape[0]) for p in prompts), default=1)
    sched = ContinuousScheduler(engine, n_slots=n_slots,
                                prompt_len=prompt_len,
                                prefix_cache=prefix_cache, tracer=tracer,
                                profiler=profiler, spec=spec)
    cow_base = engine.pool.reset_peak() if engine.paged else 0
    cache_base = prefix_cache.stats() if prefix_cache is not None else None
    for i, prompt in enumerate(prompts):
        sched.submit(Request(req_id=i, prompt=prompt,
                             max_new_tokens=max_tokens, n_samples=n))
    sched.run(rng, sc)
    serving = sched.metrics.summary()
    _attach_serving_stats(serving, engine, n_slots, cow_base, prefix_cache,
                          cache_base)
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


def _beam_callbacks(tok, task: T.MathTask, prm):
    """Tokenizer and PRM closures for a :class:`BeamSpec`: the scheduler
    sees token lists only.  The dispatch is the direct path's
    (``prm_step_scores`` / ``prm_final_scores``), so both paths score
    alike."""

    def step_score(token_lists, logprob_sum, n_gen):
        texts = [tok.decode(t) for t in token_lists]
        return np.asarray(torch.as_tensor(R.prm_step_scores(
            prm, task, texts, torch.as_tensor(logprob_sum),
            torch.as_tensor(n_gen))).cpu())

    def final_score(token_lists, logprob_sum, n_gen):
        texts = [tok.decode(t) for t in token_lists]
        return np.asarray(torch.as_tensor(R.prm_final_scores(
            prm, task, texts, torch.as_tensor(logprob_sum),
            torch.as_tensor(n_gen))).cpu())

    def finished(token_lists):
        return all("A:" in tok.decode(t) for t in token_lists)

    return step_score, final_score, finished


def serve_beam_search(engine, tok, tasks: Sequence[T.MathTask], *,
                      width: int, expand: int, step_tokens: int = 16,
                      max_steps: int = 8, rng: Optional[torch.Generator],
                      prm, n_slots: int = 8,
                      prompt_len: Optional[int] = None,
                      sc: SamplerConfig = SamplerConfig(temperature=0.8),
                      prefix_cache=None, tracer=None, profiler=None,
                      spec: Optional[SpecConfig] = None):
    """Step-level PRM beam search over a task set through the continuous
    scheduler (the served counterpart of ``core.beam_search``).

    Every task is one tree request (``search=BeamSpec(width, expand,
    ...)``): one prefill forked into ``width * expand`` lanes that decode
    in the shared slot pool; expansion is a fork (refcount bump), pruning
    a block release, and the PRM runs one batched callback per scoring
    boundary.  Returns the sweep row plus ``"results"`` (one
    :class:`~repro_torch.core.best_of_n.TTSResult` per task; under greedy
    sampling the same completions and choice as the direct path) and the
    scheduler metrics under ``"serving"``.  ``spec``: speculative rounds
    for other rows; the lanes themselves commit one token per round."""
    prompts = [torch.tensor(tok.encode(task.prompt), dtype=torch.int32)
               for task in tasks]
    if prompt_len is None:
        prompt_len = max((int(p.shape[0]) for p in prompts), default=1)
    fan = width * expand
    n_slots = max(n_slots, fan)
    sched = ContinuousScheduler(engine, n_slots=n_slots,
                                prompt_len=prompt_len,
                                prefix_cache=prefix_cache, tracer=tracer,
                                profiler=profiler, spec=spec)
    cow_base = engine.pool.reset_peak() if engine.paged else 0
    cache_base = prefix_cache.stats() if prefix_cache is not None else None
    dot_id = int(tok.encode(".", bos=False)[0])
    for i, task in enumerate(tasks):
        step_score, final_score, finished = _beam_callbacks(tok, task, prm)
        sched.submit(Request(
            req_id=i, prompt=prompts[i],
            search=BeamSpec(width=width, expand=expand,
                            step_tokens=step_tokens, max_steps=max_steps,
                            step_stop_id=dot_id, score=step_score,
                            final_score=final_score, finished=finished)))
    sched.run(rng, sc)
    serving = sched.metrics.summary()
    _attach_serving_stats(serving, engine, n_slots, cow_base, prefix_cache,
                          cache_base)
    correct = 0
    results = []
    for i, task in enumerate(tasks):
        samples = sorted(sched.completed[i], key=lambda s: s.sample_idx)
        completions = [tok.decode(s.tokens) for s in samples]
        res = sched.beam_results[i]
        chosen = res["chosen"]
        ans = T.extract_answer(completions[chosen])
        ok = (ans == task.answer) if ans is not None else False
        correct += int(ok)
        results.append(BoN.TTSResult(
            completions=completions,
            scores=torch.tensor(res["scores"], dtype=torch.float32),
            chosen=chosen, answer=ans, correct=ok,
            decode_tokens=sum(s.n_gen for s in samples)))
    return {
        "method": "beam_search",
        "budget": fan,
        "accuracy": correct / max(1, len(tasks)),
        # serving cost: every decode step a lane holds a slot, pruned
        # lanes' tokens included
        "decode_tokens": serving["decode_tokens"],
        "serving": serving,
        "results": results,
    }


def sweep(engine, tok, tasks: Sequence[T.MathTask], specs: Sequence[TTSSpec],
          rng: Optional[torch.Generator], scorer, *,
          continuous: bool = False, n_slots: int = 8, prefix_cache=None,
          tracer=None, profiler=None,
          spec_decode: Optional[SpecConfig] = None,
          sc: Optional[SamplerConfig] = None):
    """Accuracy / decode cost for each spec — one row per Pareto point.

    ``continuous=True`` serves Best-of-N and beam-search specs through the
    slot scheduler (the scheduler grows to the spec's fan-out); every
    other spec, and every spec without ``continuous``, takes the direct
    per-task path.  ``prefix_cache`` (continuous rows only) is shared by
    every row, so common prompt prefixes persist across the sweep.  One
    generator ``rng`` feeds every row in turn.  ``sc`` (None: the
    scheduler's default sampler) reaches the scheduler rows only; direct
    rows sample with their method's default, as the JAX package's
    ``sweep`` does.  ``tracer`` and ``profiler`` (continuous rows only)
    are shared by every row's scheduler.  ``spec_decode`` (continuous
    rows) enables speculative rounds; they fire only under greedy
    sampling, so pass ``sc=SamplerConfig(greedy=True)`` with it."""
    sc_kwargs = {} if sc is None else {"sc": sc}
    rows = []
    for spec in specs:
        if continuous and spec.method == "best_of_n":
            rows.append(serve_best_of_n(
                engine, tok, tasks, n=spec.budget,
                max_tokens=spec.max_tokens, rng=rng, scorer=scorer,
                n_slots=max(n_slots, spec.budget),
                prefix_cache=prefix_cache, tracer=tracer, profiler=profiler,
                spec=spec_decode, **sc_kwargs))
            continue
        if continuous and spec.method == "beam_search":
            width, expand = spec.beam_shape()
            rows.append(serve_beam_search(
                engine, tok, tasks, width=width, expand=expand,
                step_tokens=spec.step_tokens, max_steps=spec.beam_steps,
                rng=rng, prm=scorer, n_slots=max(n_slots, width * expand),
                prefix_cache=prefix_cache, tracer=tracer, profiler=profiler,
                spec=spec_decode, **sc_kwargs))
            continue
        correct = cost = 0
        for task in tasks:
            r = run_method(engine, tok, task, spec, rng, scorer)
            correct += int(r.correct)
            cost += r.decode_tokens
        rows.append({
            "method": spec.method,
            "budget": spec.budget,
            "accuracy": correct / max(1, len(tasks)),
            "decode_tokens": cost,
        })
    return rows
