"""The system under test and the closed loop that drives it.

``build`` draws the family's weights from the seed a layer at a time and
builds the port's engine as ``repro_torch.launch.serve.build_engine``
does (``quantize_model_params`` under the port's default policy,
``cast_params``, each layer as it arrives; a paged ``DecodeEngine`` over
a Q8 pool), with the cell's own ``max_len`` and one full-length
reservation per slot.  ``ClosedLoop`` keeps ``clients`` tasks
in flight: each task is one ``Request(n_samples=N)``; when its N samples
are back, ``core/best_of_n.select_best`` picks the answer under
``core/reward.LogProbScorer`` and the client submits its next task at
once.  Every step is one ``ContinuousScheduler.step_once``.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from benchlib import traffic as TR

BLOCK_SIZE = 16
# decode steps after the first admissions, before the window: every
# shape of the traffic (each admission's prefill, the full-width step)
# has run by then
WARMUP_STEPS = 4
SAMPLER_SEED_SALT = 0x5DEECE66D


def build(config: dict, mix: dict, seed: int, device, *, family, cfg=None,
          tracer=None):
    """(scheduler, engine) for a cell: the ``family``'s weights from
    ``seed`` on ``device``, W4A16 under the port's default policy, a
    paged engine over the file's KV pool, and the scheduler with the
    mix's slots, prompt length and prefix cache."""
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.models import layers
    from repro_torch.quant.qlinear import cast_params, quantize_model_params
    from repro_torch.serving.engine import ContinuousScheduler, DecodeEngine
    from repro_torch.serving.prefix_cache import PrefixCache

    cfg = cfg or family.port_config(config)
    serving = config["serving"]
    layers.set_paged_attention_impl(serving["paged_attention"])
    dtype = getattr(torch, cfg.dtype)

    def served(tree):
        return cast_params(quantize_model_params(tree), dtype)

    top, f32_layers = family.make_weights(family.dims(config), seed, device)
    params = served(top)
    # map releases each layer's f32 as its served form returns, before
    # the next layer is drawn (a for loop's name would hold it)
    params["layers"] = list(map(served, f32_layers))
    del top, f32_layers       # the f32 is gone before the pool is made
    slots = int(mix["clients"]) * int(mix["n_samples"])
    max_len = TR.max_len(mix, BLOCK_SIZE)
    tok = ByteTokenizer()
    engine = DecodeEngine(params, cfg, max_len=max_len, eos_id=tok.eos_id,
                          pad_id=tok.pad_id, paged=True, block_size=BLOCK_SIZE,
                          n_blocks=1 + slots * (max_len // BLOCK_SIZE),
                          kv_quant=serving["kv_quant"])
    cache = PrefixCache(engine.pool) if mix.get("prefix_cache") else None
    sched = ContinuousScheduler(engine, n_slots=slots,
                                prompt_len=TR.prompt_len(mix),
                                prefix_cache=cache, tracer=tracer)
    return sched, engine


@dataclass
class TaskRun:
    task: TR.Task
    t_submit: float
    t_done: Optional[float] = None
    select_s: float = 0.0
    # sample_idx -> (tokens, logprob_sum, n_gen, first_decode_step,
    # finished_step)
    samples: dict = field(default_factory=dict)


@dataclass
class StepRec:
    step: int
    occupancy: int               # rows that decoded a token


class ClosedLoop:
    """``clients`` Best-of-N tasks kept in flight on one scheduler."""

    def __init__(self, sched, stream: TR.TaskStream, n_samples: int,
                 temperature: float, seed: int, *,
                 clock=time.perf_counter):
        from repro_torch.core.reward import LogProbScorer
        from repro_torch.data.tokenizer import ByteTokenizer
        from repro_torch.serving.sampler import SamplerConfig

        self.sched = sched
        self.stream = stream
        self.n = int(n_samples)
        self.sc = SamplerConfig(temperature=float(temperature))
        self.clock = clock
        dev = sched.engine.device
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(int(seed) + SAMPLER_SEED_SALT)
        self.scorer = LogProbScorer()
        self.tok = ByteTokenizer()
        self.runs: dict[int, TaskRun] = {}
        self.inflight: dict[int, TaskRun] = {}
        self.steps: list[StepRec] = []
        self.gen_states: dict[int, torch.Tensor] = {}
        # (req_id, sample_idx) -> slot row of its latest admission
        self.rows: dict[tuple, int] = {}
        # req_id -> the step of its latest admission (its first decode)
        self.admitted: dict[int, int] = {}

    def submit(self, client: int) -> TaskRun:
        from repro_torch.serving.engine import Request

        task = self.stream.next(client)
        run = TaskRun(task=task, t_submit=self.clock())
        self.sched.submit(Request(req_id=task.index,
                                  prompt=torch.from_numpy(task.prompt),
                                  max_new_tokens=task.out_len,
                                  n_samples=self.n))
        self.runs[task.index] = self.inflight[task.index] = run
        return run

    def start(self, clients: int) -> None:
        for c in range(clients):
            self.submit(c)

    def step(self) -> StepRec:
        sched = self.sched
        s = sched.step_count
        self.gen_states[s] = self.gen.get_state()
        if not sched.step_once(self.gen, self.sc):
            raise RuntimeError("the scheduler went idle in a closed loop")
        r = sched.metrics.records[-1]
        rec = StepRec(step=s, occupancy=r.occupancy)
        if r.admitted:
            for row, slot in enumerate(sched.slots):
                if slot is not None and slot.admitted_step == s:
                    self.rows[slot.req.req_id, slot.sample_idx] = row
                    self.admitted[slot.req.req_id] = s
        for rid in list(self.inflight):
            got = sched.completed.get(rid)
            if got is not None and len(got) == self.n:
                run = self.inflight.pop(rid)
                self._finish(run, sched.completed.pop(rid))
                self.submit(run.task.client)
        self.steps.append(rec)
        return rec

    def _finish(self, run: TaskRun, samples: list) -> None:
        from repro_torch.core.best_of_n import select_best
        from repro_torch.data.tasks import MathTask

        t0 = self.clock()
        samples = sorted(samples, key=lambda c: c.sample_idx)
        texts = [self.tok.decode(c.tokens) for c in samples]
        lp = torch.tensor([c.logprob_sum for c in samples])
        ng = torch.tensor([c.n_gen for c in samples])
        select_best(MathTask(question="", answer=0, reasoning="",
                             difficulty=0), texts, self.scorer, lp, ng)
        run.t_done = self.clock()
        run.select_s = run.t_done - t0
        run.samples = {c.sample_idx: (c.tokens, c.logprob_sum, c.n_gen,
                                      c.first_decode_step, c.finished_step)
                       for c in samples}


@dataclass
class Window:
    t0: float
    t1: float
    step0: int               # first step of the window
    steps: list              # StepRec of the window
    done: list               # TaskRun completed inside the window
    open_ages: list          # age at t1 of each task still in flight
    saved0: int              # prefill tokens the prefix cache had saved


def run_window(loop: ClosedLoop, seconds: float, on_step=None) -> tuple:
    """Warm up (every client's first task admitted, then
    ``WARMUP_STEPS`` more steps), then step for ``seconds``.  Returns
    (the warm-up's end on the loop's clock, Window).  ``on_step(loop,
    window_t0)`` runs before each step of the window (the traced run's
    profiler switch)."""
    sched = loop.sched
    while sched.queue:
        loop.step()
    for _ in range(WARMUP_STEPS):
        loop.step()
    # what set-up made lives to the end: the collector need not walk it
    gc.collect()
    gc.freeze()
    t0 = loop.clock()
    step0 = sched.step_count
    saved0 = sched.metrics.prefill_tokens_saved
    while loop.clock() - t0 < seconds:
        if on_step is not None:
            on_step(loop, t0)
        loop.step()
    t1 = loop.clock()
    steps = [r for r in loop.steps if r.step >= step0]
    done = [r for r in loop.runs.values()
            if r.t_done is not None and t0 <= r.t_done <= t1]
    ages = [t1 - r.t_submit for r in loop.inflight.values()]
    return t0, Window(t0=t0, t1=t1, step0=step0, steps=steps, done=done,
                      open_ages=ages, saved0=saved0)


def seq_of(run: TaskRun, idx: int) -> np.ndarray:
    """The prompt and served tokens of one sample, as one sequence."""
    return np.concatenate([run.task.prompt,
                           np.asarray(run.samples[idx][0], np.int32)])
