"""Batched paged decode engine and the continuous-batching scheduler.

Decode is weight-bandwidth-bound, so a decode batch has idle rows that
parallel test-time-scaling samples occupy for almost nothing; the engine
treats batch as the first-class resource:

* ``prefill`` runs each prompt once and yields the next-token logits at
  each row's true last position;
* ``fork`` replicates rows so N samples share one prompt's prefill — on
  the paged pool a refcount bump, zero KV copied until copy-on-write
  splits a shared block at its first divergent write;
* ``step`` samples one token per row and runs one decode step.

The state carries ``pending_logits``, the logits the next token is
sampled from, so no KV row is written twice and the first generated
token is sampled from the prefill logits exactly.

KV lives in a refcounted block pool (:class:`~repro_torch.serving.
kv_pool.KVPool`, or the tile-quantized :class:`~repro_torch.serving.
kv_quant.QuantKVPool`) and each row holds a block table.  The pool's
device storage is updated **in place** by prefill, decode and CoW (the
JAX package's jit and buffer donation have no counterpart: PyTorch runs
eagerly); the block tables and owned-block counts are host-side numpy,
uploaded once per step.  Paged states reference pool blocks by id and
must be used linearly.  ``prepare_decode`` plans each step's block
allocation and CoW on the host and raises :class:`~repro_torch.serving.
kv_pool.OutOfBlocks` atomically when the pool is short, which the
scheduler turns into preempting the youngest request.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.serving.kv_pool import KVPool, OutOfBlocks, blocks_for
from repro_torch.serving.sampler import SamplerConfig, logprobs_of, sample


@dataclass
class GenState:
    """Decoding state for a batch of sequences.

    ``table`` (B, W) int32 block ids and ``n_blocks`` (B,) owned-block
    counts are host numpy; the per-row vectors live on the engine's
    device."""

    table: np.ndarray
    n_blocks: np.ndarray
    cache_len: torch.Tensor       # (B,) int32 — prompt + generated so far
    pending_logits: torch.Tensor  # (B, V) f32 — next token sampled from
    done: torch.Tensor            # (B,) bool
    logprob_sum: torch.Tensor     # (B,) f32 cumulative sampled logprob
    n_gen: torch.Tensor           # (B,) int32


class DecodeEngine:
    """Paged decode engine over one model.

    ``params`` must already live on the engine's device (the device is
    taken from the embedding table).  ``kv_quant`` "q8" | "q4" stores the
    pool tile-quantized."""

    def __init__(self, params, cfg: ModelConfig, *, max_len: int = 512,
                 eos_id: int = 1, pad_id: int = 0, block_size: int = 16,
                 n_blocks: Optional[int] = None, kv_quant: str = "none"):
        self.params = params
        self.cfg = cfg
        self.model = api.get_model(cfg)
        self.device = params["embedding"]["table"].device
        self.max_len = max_len
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.kv_quant = kv_quant
        if max_len % block_size:
            raise ValueError(f"max_len ({max_len}) must be a multiple of "
                             f"block_size ({block_size})")
        if n_blocks is None:
            # scratch + eight full-length sequences' worth by default
            n_blocks = 1 + 8 * (max_len // block_size)
        if kv_quant != "none":
            from repro_torch.serving.kv_quant import QuantKVPool

            self.pool: KVPool = QuantKVPool(cfg, n_blocks, block_size,
                                            mode=kv_quant,
                                            device=self.device)
        else:
            self.pool = KVPool(cfg, n_blocks, block_size, device=self.device)

    @property
    def table_width(self) -> int:
        """Block-table slots per row (= max_len / block_size)."""
        return self.max_len // self.pool.block_size

    def _vec(self, values, dtype) -> torch.Tensor:
        return torch.as_tensor(values, dtype=dtype, device=self.device)

    def _cache(self, table: np.ndarray) -> dict:
        return {"k": self.pool.k, "v": self.pool.v,
                "table": self._vec(table, torch.int32)}

    # -- prefill ------------------------------------------------------------
    def prefill(self, tokens: torch.Tensor,
                lengths: Optional[torch.Tensor] = None) -> GenState:
        """tokens: (B, S) right-padded prompts; lengths: (B,) true lengths.
        Allocates the prompts' blocks (host) and scatters their KV in."""
        B, S = tokens.shape
        tokens = tokens.to(self.device)
        if lengths is None:
            lengths = torch.full((B,), S, dtype=torch.int32)
        lens_h = np.asarray(lengths.cpu(), np.int64)
        bs = self.pool.block_size
        per_row = [blocks_for(n, bs) for n in lens_h]
        if not self.pool.reserve(sum(per_row)):
            raise OutOfBlocks(sum(per_row), self.pool.free_blocks)
        table = np.zeros((B, self.table_width), np.int32)
        n_blocks = np.zeros((B,), np.int32)
        for i, n in enumerate(per_row):
            table[i, :n] = self.pool.alloc(n)
            n_blocks[i] = n
        lengths = self._vec(lens_h, torch.int32)
        logits = self.model.prefill(self.params, tokens, self.cfg,
                                    lengths=lengths,
                                    paged=self._cache(table))
        return GenState(
            table=table, n_blocks=n_blocks, cache_len=lengths,
            pending_logits=logits.float(),
            done=torch.zeros((B,), dtype=torch.bool, device=self.device),
            logprob_sum=torch.zeros((B,), device=self.device),
            n_gen=torch.zeros((B,), dtype=torch.int32, device=self.device))

    def empty_state(self, batch: int) -> GenState:
        """An all-free decoding state of ``batch`` rows (every row done,
        holding zero blocks) — the scheduler's persistent slot state."""
        return GenState(
            table=np.zeros((batch, self.table_width), np.int32),
            n_blocks=np.zeros((batch,), np.int32),
            cache_len=torch.zeros((batch,), dtype=torch.int32,
                                  device=self.device),
            pending_logits=torch.zeros((batch, self.cfg.vocab_size),
                                       device=self.device),
            done=torch.ones((batch,), dtype=torch.bool, device=self.device),
            logprob_sum=torch.zeros((batch,), device=self.device),
            n_gen=torch.zeros((batch,), dtype=torch.int32,
                              device=self.device))

    # -- row scatter (continuous-batching admission) -------------------------
    def merge_rows(self, dst: GenState, src: GenState, rows) -> GenState:
        """Scatter ``src``'s rows into ``dst`` at indices ``rows`` (in
        place on ``dst``'s tensors).  The overwritten ``dst`` rows must
        already be released: block ownership moves from ``src`` rows to
        ``dst`` rows without touching refcounts."""
        rows_h = np.asarray(rows, np.int64).ravel()
        dst.table[rows_h] = src.table
        dst.n_blocks[rows_h] = src.n_blocks
        r = self._vec(rows_h, torch.long)
        for name in ("cache_len", "pending_logits", "done", "logprob_sum",
                     "n_gen"):
            getattr(dst, name)[r] = getattr(src, name)
        return dst

    def release_rows(self, state: GenState, rows) -> GenState:
        """Mark ``rows`` done and free their blocks back to the pool
        (tables re-pointed at the scratch block)."""
        rows = np.asarray(rows, np.int64).ravel()
        for r in rows:
            self.pool.release(state.table[r, :state.n_blocks[r]])
            state.table[r] = 0
            state.n_blocks[r] = 0
        if rows.size:
            state.done[self._vec(rows, torch.long)] = True
        return state

    def fork(self, state: GenState, n: int) -> GenState:
        """Replicate each row n times (row i -> rows [i*n, (i+1)*n)): bumps
        the refcount of every owned block and repeats the table row, so no
        KV block is allocated or copied."""
        if n > 1:
            for i in range(state.table.shape[0]):
                self.pool.retain(state.table[i, :state.n_blocks[i]],
                                 times=n - 1)

        def rep(x):
            return x.repeat_interleave(n, dim=0)

        return GenState(
            table=np.repeat(state.table, n, axis=0),
            n_blocks=np.repeat(state.n_blocks, n, axis=0),
            cache_len=rep(state.cache_len),
            pending_logits=rep(state.pending_logits), done=rep(state.done),
            logprob_sum=rep(state.logprob_sum), n_gen=rep(state.n_gen))

    # -- paged block bookkeeping ---------------------------------------------
    def prepare_decode(self, state: GenState, n_steps: int = 1) -> GenState:
        """Host-side block planning before decoding ``n_steps`` tokens.

        For every live row: allocate the blocks its next writes land in,
        and copy-on-write any still-shared block at or past the write
        frontier (post-fork tail blocks).  The whole plan is committed
        only if the free list covers it, so an :class:`OutOfBlocks` raise
        leaves pool and state untouched."""
        clen, done = (t.cpu().numpy() for t in (state.cache_len, state.done))
        table, n_blocks = state.table.copy(), state.n_blocks.copy()
        bs = self.pool.block_size
        plan_new: list[tuple] = []     # (row, slot)
        plan_cow: list[tuple] = []     # (row, slot, old_block)
        # planned CoWs drop a reference each, so the last planner of a
        # shared block sees an effective refcount of 1 and writes in place
        # (an n-way fork costs n-1 copies, not n)
        pending_drops: dict[int, int] = {}
        for i in range(table.shape[0]):
            if done[i]:
                continue
            last = int(clen[i]) + n_steps - 1   # final position written
            if last > self.max_len - 2:
                raise ValueError(
                    f"row {i}: decoding {n_steps} steps from length "
                    f"{int(clen[i])} overruns the usable sequence length "
                    f"{self.max_len - 1} (last slot is KV scratch)")
            for s in range(int(clen[i]) // bs, int(n_blocks[i])):
                blk = int(table[i, s])
                if self.pool.refcount[blk] - pending_drops.get(blk, 0) > 1:
                    plan_cow.append((i, s, blk))
                    pending_drops[blk] = pending_drops.get(blk, 0) + 1
            for s in range(int(n_blocks[i]), last // bs + 1):
                plan_new.append((i, s))
        needed = len(plan_new) + len(plan_cow)
        if not needed:
            return state
        if not self.pool.reserve(needed):
            raise OutOfBlocks(needed, self.pool.free_blocks)
        new_ids = self.pool.cow([b for _, _, b in plan_cow])
        for (i, s, _), bid in zip(plan_cow, new_ids):
            table[i, s] = bid
        for (i, s), bid in zip(plan_new, self.pool.alloc(len(plan_new))):
            table[i, s] = bid
            n_blocks[i] = max(n_blocks[i], s + 1)
        return dataclasses.replace(state, table=table, n_blocks=n_blocks)

    # -- decode -------------------------------------------------------------
    def step(self, state: GenState, generator: Optional[torch.Generator],
             sc: SamplerConfig = SamplerConfig(), stop_ids: tuple = ()):
        """One decode step.  Returns (new_state, sampled tokens (B,)).

        Runs :meth:`prepare_decode` first (may raise :class:`OutOfBlocks`),
        then samples from the pending logits and scatters this step's KV
        into the pool in place."""
        state = self.prepare_decode(state)
        stop_ids = tuple(stop_ids) or (self.eos_id,)
        tok = sample(state.pending_logits, generator, sc)
        lp = logprobs_of(state.pending_logits, tok)
        tok = torch.where(state.done, self.pad_id, tok).to(torch.int32)
        new_done = state.done.clone()
        for s in stop_ids:
            new_done |= tok == s
        new_len = torch.where(state.done, state.cache_len,
                              state.cache_len + 1)
        # done rows route their discarded write to position max_len - 1,
        # which the table maps to the scratch block or an unattended final
        # offset (usable sequence length is max_len - 1)
        model_len = torch.where(state.done, self.max_len, new_len).to(
            torch.int32)
        logits = self.model.decode_step(self.params, tok[:, None],
                                        self._cache(state.table), model_len,
                                        self.cfg)
        pending = torch.where(state.done[:, None], state.pending_logits,
                              logits.float())
        return GenState(
            table=state.table, n_blocks=state.n_blocks,
            cache_len=new_len.to(torch.int32), pending_logits=pending,
            done=new_done,
            logprob_sum=state.logprob_sum + torch.where(
                state.done, torch.zeros_like(lp), lp),
            n_gen=state.n_gen + (~state.done).to(torch.int32)), tok


# ---------------------------------------------------------------------------
# Continuous batching
# ---------------------------------------------------------------------------


@dataclass
class Request:
    req_id: int
    prompt: torch.Tensor         # (S,) int32
    max_new_tokens: int = 64
    n_samples: int = 1           # > 1: TTS fan-out sharing one prefill


@dataclass
class CompletedSample:
    """One finished slot occupancy (one sample of one request)."""

    req_id: int
    sample_idx: int
    tokens: list                 # generated ids, stop token excluded
    logprob_sum: float           # cumulative sampled logprob
    n_gen: int                   # tokens sampled incl. any stop token
    finish_reason: str           # "stop" | "length"
    admitted_step: int
    first_decode_step: int
    finished_step: int


@dataclass
class _Slot:
    req: Request
    sample_idx: int
    admitted_step: int
    tokens: list = field(default_factory=list)
    first_decode_step: int = -1


@dataclass
class StepRecord:
    step: int
    occupancy: int               # rows decoding this step
    admitted: int                # requests admitted this step
    prefill_tokens: int          # prompt tokens prefilled this step
    wall_s: float = 0.0          # host wall time of this step


def percentile(xs, q: float) -> float:
    """Linear-interpolated percentile; 0.0 on empty input."""
    xs = list(xs)
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else 0.0


class SchedulerMetrics:
    """Step-level metrics of the continuous batching loop."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self.records: list[StepRecord] = []
        self.completed_requests = 0
        self.completed_samples = 0
        self.preemptions = 0
        self.wall_s = 0.0
        self.prefill_calls = 0
        self.peak_kv_bytes = 0   # dtype-aware paged KV high-water mark
        self.kv_quant = "none"

    def record(self, rec: StepRecord):
        self.records.append(rec)

    def summary(self) -> dict:
        steps = len(self.records)
        decode = sum(r.occupancy for r in self.records)
        step_ts = [r.wall_s for r in self.records]
        return {
            "admitted_requests": sum(r.admitted for r in self.records),
            "prefill_calls": self.prefill_calls,
            "steps": steps,
            "n_slots": self.n_slots,
            "avg_slot_occupancy": (decode / (steps * self.n_slots)
                                   if steps else 0.0),
            "decode_tokens": decode,
            "prefill_tokens": sum(r.prefill_tokens for r in self.records),
            "completed_requests": self.completed_requests,
            "completed_samples": self.completed_samples,
            "preemptions": self.preemptions,
            "wall_s": self.wall_s,
            "requests_per_s": (self.completed_requests / self.wall_s
                               if self.wall_s > 0 else 0.0),
            "decode_tok_per_s": (decode / self.wall_s
                                 if self.wall_s > 0 else 0.0),
            "peak_kv_bytes": self.peak_kv_bytes,
            "kv_quant": self.kv_quant,
            "step_time_p50": percentile(step_ts, 50),
            "step_time_p99": percentile(step_ts, 99),
        }


class ContinuousScheduler:
    """Slot-based continuous batching on top of :class:`DecodeEngine`.

    One persistent ``GenState`` of ``n_slots`` rows decodes every step;
    requests flow through slots independently:

    1. **Admit** — while free slots and pool blocks remain, runs of plain
       requests at the queue head share one batched prefill and are
       scattered into free rows; a TTS request (``n_samples > 1``) does
       one prefill and ``fork``\\ s into ``n_samples`` slots.
    2. **Decode** — one batched ``DecodeEngine.step`` over all rows (free
       rows are done and cost an idle lane).
    3. **Release** — a row that samples a stop id or reaches its
       ``max_new_tokens`` frees its slot and blocks immediately.

    When a decode step cannot get its blocks (:class:`OutOfBlocks`), the
    youngest live request is preempted — slots released, blocks freed,
    requeued at the head to rerun from scratch — and the step retried.
    """

    def __init__(self, engine: DecodeEngine, n_slots: int = 8,
                 prompt_len: int = 32, stop_ids: tuple = ()):
        self.engine = engine
        self.n_slots = n_slots
        self.prompt_len = prompt_len
        self.stop_ids = tuple(stop_ids) or (engine.eos_id,)
        self.queue: deque[Request] = deque()
        self.slots: list[Optional[_Slot]] = [None] * n_slots
        self.state: Optional[GenState] = None   # built on first admission
        self.step_count = 0
        self.completed: dict[int, list[CompletedSample]] = {}
        self._n_samples: dict[int, int] = {}
        self.metrics = SchedulerMetrics(n_slots)
        self.metrics.kv_quant = engine.pool.mode
        self._block_bytes = engine.pool.block_bytes()

    # -- submission ----------------------------------------------------------
    def submit(self, req: Request):
        if req.req_id in self._n_samples:
            raise ValueError(f"request id {req.req_id} already submitted")
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.req_id}: max_new_tokens must be "
                             f">= 1, got {req.max_new_tokens}")
        if req.n_samples > self.n_slots:
            raise ValueError(f"request {req.req_id}: n_samples="
                             f"{req.n_samples} exceeds n_slots={self.n_slots}")
        plen = int(req.prompt.shape[0])
        if plen > self.prompt_len:
            raise ValueError(f"request {req.req_id}: prompt length {plen} "
                             f"exceeds prompt_len={self.prompt_len}")
        budget = plen + req.max_new_tokens
        if budget > self.engine.max_len - 1:
            raise ValueError(
                f"request {req.req_id}: prompt ({plen}) + new tokens "
                f"({req.max_new_tokens}) = {budget} exceeds engine max_len "
                f"- 1 = {self.engine.max_len - 1}")
        worst = self._worst_case_blocks(req)
        if worst > self.engine.pool.capacity:
            raise ValueError(
                f"request {req.req_id}: worst-case KV footprint ({worst} "
                f"blocks) exceeds pool capacity "
                f"({self.engine.pool.capacity} blocks)")
        self._n_samples[req.req_id] = max(1, req.n_samples)
        self.queue.append(req)

    def _worst_case_blocks(self, req: Request) -> int:
        """Blocks the request needs alone at full divergence: shared full
        prompt blocks + per-sample tail CoW and growth."""
        bs = self.engine.pool.block_size
        plen = int(req.prompt.shape[0])
        shared = plen // bs
        per_sample = blocks_for(plen + req.max_new_tokens, bs) - shared
        return shared + max(1, req.n_samples) * per_sample

    def _pad(self, prompt):
        out = torch.full((self.prompt_len,), self.engine.pad_id,
                         dtype=torch.int32)
        out[:prompt.shape[0]] = prompt.cpu()
        return out, int(prompt.shape[0])

    def _prompt_blocks(self, req: Request) -> int:
        return blocks_for(int(req.prompt.shape[0]),
                          self.engine.pool.block_size)

    # -- admission -----------------------------------------------------------
    def _merge(self, st: GenState, rows: list):
        if self.state is None:
            self.state = self.engine.empty_state(self.n_slots)
        self.state = self.engine.merge_rows(self.state, st, rows)

    def _admit_plain(self, reqs: list, free: list) -> int:
        """One batched prefill + one merge for a run of plain requests."""
        padded = [self._pad(r.prompt) for r in reqs]
        st = self.engine.prefill(
            torch.stack([t for t, _ in padded]),
            torch.tensor([n for _, n in padded], dtype=torch.int32))
        self.metrics.prefill_calls += 1
        rows = [free.pop(0) for _ in reqs]
        self._merge(st, rows)
        for req, r in zip(reqs, rows):
            self.slots[r] = _Slot(req=req, sample_idx=0,
                                  admitted_step=self.step_count)
        return sum(n for _, n in padded)

    def _admit_group(self, req: Request, free: list) -> int:
        """TTS group: one batch-1 prefill forked into ``n_samples`` slots
        sharing the prompt's blocks until their first divergent write."""
        n = max(1, req.n_samples)
        toks, length = self._pad(req.prompt)
        st = self.engine.prefill(toks[None],
                                 torch.tensor([length], dtype=torch.int32))
        self.metrics.prefill_calls += 1
        if n > 1:
            st = self.engine.fork(st, n)
        rows = [free.pop(0) for _ in range(n)]
        self._merge(st, rows)
        for j, r in enumerate(rows):
            self.slots[r] = _Slot(req=req, sample_idx=j,
                                  admitted_step=self.step_count)
        return length

    def _admit(self) -> tuple:
        """Fill free slots from the queue (FIFO).  Admission stops when the
        head does not fit the free slots or the pool's free blocks (decode
        growth is handled by preemption, not reservation).  Returns
        (requests admitted, prompt tokens prefilled)."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        admitted = prefill_tokens = 0
        blk_budget = self.engine.pool.free_blocks
        while self.queue and free:
            head = self.queue[0]
            if max(1, head.n_samples) > len(free):
                break  # FIFO: the group waits for enough free slots
            if self._prompt_blocks(head) > blk_budget:
                break  # FIFO: the head waits for blocks to free up
            if head.n_samples > 1:
                req = self.queue.popleft()
                blk_budget -= self._prompt_blocks(req)
                prefill_tokens += self._admit_group(req, free)
                admitted += 1
                continue
            plain = []
            while (self.queue and self.queue[0].n_samples <= 1
                   and len(plain) < len(free)):
                need = self._prompt_blocks(self.queue[0])
                if need > blk_budget:
                    break
                blk_budget -= need
                plain.append(self.queue.popleft())
            if not plain:
                break
            prefill_tokens += self._admit_plain(plain, free)
            admitted += len(plain)
        return admitted, prefill_tokens

    # -- release / preemption ------------------------------------------------
    def _release(self, row: int, reason: str, logprob_sum: float,
                 n_gen: int):
        slot = self.slots[row]
        done = self.completed.setdefault(slot.req.req_id, [])
        done.append(CompletedSample(
            req_id=slot.req.req_id, sample_idx=slot.sample_idx,
            tokens=slot.tokens, logprob_sum=logprob_sum, n_gen=n_gen,
            finish_reason=reason, admitted_step=slot.admitted_step,
            first_decode_step=slot.first_decode_step,
            finished_step=self.step_count))
        self.metrics.completed_samples += 1
        if len(done) == max(1, slot.req.n_samples):
            self.metrics.completed_requests += 1
        self.slots[row] = None

    def _preempt_youngest(self):
        """Free the youngest live request's slots and blocks and requeue it
        at the head (it reruns from scratch).  Raises when only one live
        request remains: the pool is too small to make progress."""
        by_req: dict[int, list[int]] = {}
        for i, s in enumerate(self.slots):
            if s is not None:
                by_req.setdefault(s.req.req_id, []).append(i)
        if len(by_req) <= 1:
            raise RuntimeError("KV pool exhausted with a single live request "
                               "— pool too small to make progress (raise "
                               "n_blocks)")
        victim = max(by_req, key=lambda rid: (
            self.slots[by_req[rid][0]].admitted_step, rid))
        rows = by_req[victim]
        req = self.slots[rows[0]].req
        self.state = self.engine.release_rows(self.state, rows)
        for r in rows:
            self.slots[r] = None
        # the rerun regenerates every sample (deterministic under greedy)
        dropped = self.completed.pop(victim, [])
        self.metrics.completed_samples -= len(dropped)
        self.queue.appendleft(req)
        self.metrics.preemptions += 1

    # -- the step loop -------------------------------------------------------
    def step_once(self, generator: Optional[torch.Generator],
                  sc: SamplerConfig = SamplerConfig()) -> bool:
        """One scheduler step (admit → decode → release).  Returns False
        when idle.  The step's host wall time, which ends with the copy of
        the sampled tokens to the host, lands in ``StepRecord.wall_s``."""
        t_wall = time.perf_counter()
        admitted, prefill_tokens = self._admit()
        live = [i for i, s in enumerate(self.slots) if s is not None]
        if not live:
            return False
        for i in live:
            if self.slots[i].first_decode_step < 0:
                self.slots[i].first_decode_step = self.step_count
        while True:
            try:
                self.state, toks = self.engine.step(
                    self.state, generator, sc, stop_ids=self.stop_ids)
                break
            except OutOfBlocks:
                # atomic: the failed plan touched neither pool nor state
                self._preempt_youngest()
                live = [i for i, s in enumerate(self.slots) if s is not None]
        toks_h, done_h, lp_h, ng_h = (
            t.cpu().numpy() for t in (toks, self.state.done,
                                      self.state.logprob_sum,
                                      self.state.n_gen))
        released = []
        for i in live:
            slot = self.slots[i]
            if bool(done_h[i]):          # sampled a stop id (excluded)
                self._release(i, "stop", float(lp_h[i]), int(ng_h[i]))
                released.append(i)
                continue
            slot.tokens.append(int(toks_h[i]))
            if len(slot.tokens) >= slot.req.max_new_tokens:
                self._release(i, "length", float(lp_h[i]), int(ng_h[i]))
                released.append(i)
        if released:
            self.state = self.engine.release_rows(self.state, released)
        self.metrics.peak_kv_bytes = max(
            self.metrics.peak_kv_bytes,
            self.engine.pool.peak_in_use * self._block_bytes)
        wall = time.perf_counter() - t_wall
        self.metrics.wall_s += wall
        self.metrics.record(StepRecord(
            step=self.step_count, occupancy=len(live), admitted=admitted,
            prefill_tokens=prefill_tokens, wall_s=wall))
        self.step_count += 1
        return True

    def run(self, generator: Optional[torch.Generator],
            sc: SamplerConfig = SamplerConfig(), max_steps: int = 4096):
        """Drain the queue.  Returns ``{req_id: tokens}`` for plain requests
        and ``{req_id: [tokens] * n_samples}`` for TTS requests.  Raises
        ``RuntimeError`` if ``max_steps`` elapses with work left."""
        steps = 0
        while steps < max_steps and self.step_once(generator, sc):
            steps += 1
        live = sum(1 for s in self.slots if s is not None)
        if self.queue or live:
            raise RuntimeError(
                f"scheduler truncated at max_steps={max_steps}: "
                f"{len(self.queue)} queued + {live} decoding requests "
                f"unfinished")
        results = {}
        for req_id, samples in self.completed.items():
            ordered = sorted(samples, key=lambda s: s.sample_idx)
            if self._n_samples.get(req_id, 1) == 1:
                results[req_id] = ordered[0].tokens
            else:
                results[req_id] = [s.tokens for s in ordered]
        return results
