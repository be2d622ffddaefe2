"""Batched decode engine and the continuous-batching scheduler.

Decode is weight-bandwidth-bound, so a decode batch has idle rows that
parallel test-time-scaling samples occupy for almost nothing; the engine
treats batch as the first-class resource:

* ``prefill`` runs each prompt once and yields the next-token logits at
  each row's true last position; with a cached prefix (a prefix-cache
  hit) it runs only the uncached suffix, reading the cached blocks;
* ``fork`` replicates rows so N samples share one prompt's prefill — on
  the paged pool a refcount bump, zero KV copied until copy-on-write
  splits a shared block at its first divergent write;
* ``step`` samples one token per row and runs one decode step;
  ``generate`` plans a whole horizon's blocks once and runs ``n_steps``
  steps (the direct TTS path);
* ``reorder`` gathers rows (beam-search survivors): a dropped row
  releases its blocks, a row taken k times gains k - 1 references;
  ``freeze_rows`` / ``resume_rows`` / ``resume`` stop and re-arm rows
  without touching their blocks.

The state carries ``pending_logits``, the logits the next token is
sampled from, so no KV row is written twice and the first generated
token is sampled from the prefill logits exactly.

Speculative decoding (``spec_verify``, ``spec_snapshot``, ``trim_rows``)
commits the longest greedy-agreeing prefix of several proposed tokens
per row in one forward; the scheduler drafts them with the target on a
refcounted snapshot of its own rows or with a small dense model
(``forced_step``).

The engine runs in one of two KV layouts.  **Dense** (``paged=False``,
the default): each row owns its cache rows (a transformer's (max_len,
Hkv, D) KV slots per layer; a Mamba2 model's conv and SSM states, and the
zamba2 hybrid's shared-block KV), and ``fork`` / ``reorder`` /
``merge_rows`` copy every leaf's rows; the speculative drafter and the
Mamba2 / hybrid families run on it.
**Paged** (``paged=True``): KV lives in a refcounted block pool
(:class:`~repro_torch.serving.kv_pool.KVPool`, or the tile-quantized
:class:`~repro_torch.serving.kv_quant.QuantKVPool`) and each row holds a
block table.  The pool's
device storage is updated **in place** by prefill, decode and CoW (the
JAX package's jit and buffer donation have no counterpart: PyTorch runs
eagerly); the block tables and owned-block counts are host-side numpy,
uploaded once per step.  Paged states reference pool blocks by id and
must be used linearly.  ``prepare_decode`` plans each step's block
allocation and CoW on the host and raises :class:`~repro_torch.serving.
kv_pool.OutOfBlocks` atomically when the pool is short, which the
scheduler turns into preempting the youngest request.  On a card, the
scheduler's plain decode steps replay the paged forward from one CUDA
graph per engine (:mod:`~repro_torch.serving.decode_graph`,
:meth:`DecodeEngine._graph_for`); every other caller runs it eager.

Observability: a :class:`~repro_torch.serving.telemetry.Tracer` records
the scheduler's request lifecycle events, phase spans and gauges, and a
:class:`~repro_torch.serving.profiling.KernelProfiler` the kernels'
analytic cost per phase, sampled phase walls and the numerics canary
(``ContinuousScheduler(tracer=, profiler=)``).  Both default to None: no
event, no hook, bit-identical outputs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.serving.decode_graph import DecodeGraph, pool_pointers
from repro_torch.serving.kv_pool import KVPool, OutOfBlocks, blocks_for
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.profiling import NULL_PROFILE_METRICS
from repro_torch.serving.sampler import SamplerConfig, logprobs_of, sample
from repro_torch.serving.telemetry import (RequestLatency, Tracer, cuda_mark,
                                           percentile)


@dataclass
class GenState:
    """Decoding state for a batch of sequences.

    Paged states carry ``table`` (B, W) int32 block ids and ``n_blocks``
    (B,) owned-block counts as host numpy, their KV living in the
    engine's pool; dense states carry ``cache``, the model's dense rows
    (``init_cache``: a transformer's {"k", "v"} of (L, B, max_len, Hkv,
    D), a Mamba2 model's {"conv", "ssm"[, "attn_k", "attn_v"]}, a Whisper
    model's {"k", "v", "cross_k", "cross_v"}, batch on axis 1 of every
    leaf), and no table.  The per-row vectors live on the
    engine's device."""

    table: Optional[np.ndarray]
    n_blocks: Optional[np.ndarray]
    cache_len: torch.Tensor       # (B,) int32 — prompt + generated so far
    pending_logits: torch.Tensor  # (B, V) f32 — next token sampled from
    done: torch.Tensor            # (B,) bool
    logprob_sum: torch.Tensor     # (B,) f32 cumulative sampled logprob
    n_gen: torch.Tensor           # (B,) int32
    cache: Optional[dict] = None  # dense layout only


class DecodeEngine:
    """Decode engine over one model, on dense KV rows or (``paged=True``)
    a block pool.

    ``params`` must already live on the engine's device (the device is
    taken from the embedding table).  ``kv_quant`` "q8" | "q4" stores the
    pool tile-quantized (paged only)."""

    def __init__(self, params, cfg: ModelConfig, *, max_len: int = 512,
                 eos_id: int = 1, pad_id: int = 0, paged: bool = False,
                 block_size: int = 16, n_blocks: Optional[int] = None,
                 kv_quant: str = "none"):
        self.params = params
        self.cfg = cfg
        self.model = api.get_model(cfg)
        self.device = params["embedding"]["table"].device
        self.max_len = max_len
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.paged = paged
        self.kv_quant = kv_quant
        self.pool: Optional[KVPool] = None
        # phase-span telemetry and the roofline/canary profiler, bound by
        # ContinuousScheduler(tracer=..., profiler=...).  None = zero
        # overhead: every touchpoint is behind an `is not None` test.
        self.tracer: Optional[Tracer] = None
        self.profiler = None
        self.last_canary_logits: Optional[torch.Tensor] = None
        # the decode forward's CUDA graph (paged engines on a card): at
        # most one capture per engine (see _graph_for)
        self._graph: Optional[DecodeGraph] = None
        self._graph_warm: Optional[tuple] = None
        if kv_quant != "none" and not paged:
            raise ValueError("kv_quant requires the paged KV layout "
                             "(DecodeEngine(paged=True))")
        if not paged:
            return
        if cfg.family != "transformer":
            raise ValueError(
                f"paged KV cache supports the transformer family only "
                f"(got {cfg.family!r})")
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

    def _cache(self, state: GenState) -> dict:
        """The model's cache handle for ``state``: its dense rows, or the
        pool with its block table."""
        if not self.paged:
            return state.cache
        return self._paged_handle(state.table)

    # -- prefill ------------------------------------------------------------
    def prefill(self, tokens: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                embeddings: Optional[torch.Tensor] = None, *,
                cached_table=None, cached_lens=None) -> GenState:
        """tokens: (B, S) right-padded prompts; lengths: (B,) true lengths.
        Allocates the prompts' blocks (host) and scatters their KV in.
        ``embeddings``: a (B, P, d) modality-stub prefix (``patch_stub``
        configs) replacing the first P positions' token embeddings, or an
        encoder-decoder's (B, T_enc, d) frames, whose cross K/V the dense
        rows then hold (``fork``, ``reorder`` and ``merge_rows`` carry
        them as every other dense leaf).

        Partial prefill: ``cached_table`` (B, Wc) block ids covering each
        row's cached prompt prefix plus ``cached_lens`` (B,) cached
        lengths switch ``tokens``/``lengths`` to describing the uncached
        suffix only.  The model runs over the suffix while attending over
        the cached blocks; each row must arrive holding one reference per
        cached block (the lease ``PrefixCache.match`` takes), which the
        resulting state owns.  A cached length that is not a block
        multiple has its partly used tail block copy-on-written before
        the suffix extends it, so shared cache blocks are never written.
        Every row needs at least one suffix token.  Rows may carry ragged
        cached lengths (aligned or mid-block) and suffix lengths.

        Dense engines write the prompts into fresh (max_len) cache rows
        and take no cached prefix.

        With a tracer the call is a ``prefill`` span; with a profiler a
        ``prefill`` phase whose sampled wall ends with a synchronize on
        the new logits."""
        tr, prof = self.tracer, self.profiler
        t0 = tr.now() if tr is not None else 0.0
        pt0 = prof.phase_begin("prefill") if prof is not None else 0.0
        st = self._prefill(tokens, lengths, embeddings, cached_table,
                           cached_lens)
        if prof is not None:
            prof.phase_end("prefill", pt0, outputs=st.pending_logits)
        if tr is not None:
            tr.span("prefill", t0, batch=int(tokens.shape[0]),
                    cached=cached_table is not None)
        return st

    def _prefill(self, tokens, lengths, embeddings, cached_table,
                 cached_lens):
        B, S = tokens.shape
        tokens = tokens.to(self.device)
        if embeddings is not None:
            embeddings = embeddings.to(self.device)
        if lengths is None:
            lengths = torch.full((B,), S, dtype=torch.int32)
        lens_h = np.asarray(lengths.cpu(), np.int64)
        if cached_table is not None:
            if not self.paged:
                raise ValueError("cached-prefix prefill requires a paged "
                                 "engine (DecodeEngine(paged=True))")
            if embeddings is not None:
                raise NotImplementedError(
                    "cached-prefix prefill does not support modality-stub "
                    "embeddings")
            return self._prefill_with_prefix(tokens, lens_h, cached_table,
                                             cached_lens)
        if not self.paged:
            lengths = self._vec(lens_h, torch.int32)
            # an encoder-decoder's cross K/V rows take the frames' length
            extra = ({"t_enc": embeddings.shape[1]}
                     if self.cfg.family == "encdec" else {})
            cache = self.model.init_cache(self.cfg, B, self.max_len,
                                          device=self.device, **extra)
            logits = self.model.prefill(self.params, tokens, self.cfg,
                                        lengths=lengths, cache=cache,
                                        embeddings=embeddings)
            return self._prefilled_state(None, None, lengths, logits,
                                         cache=cache)
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
                                    paged=self._paged_handle(table),
                                    embeddings=embeddings)
        return self._prefilled_state(table, n_blocks, lengths, logits)

    def _paged_handle(self, table: np.ndarray) -> dict:
        return self._pool_handle(self._vec(table, torch.int32))

    def _pool_handle(self, table: torch.Tensor) -> dict:
        """The pool with a block table already on the device."""
        return {"k": self.pool.k, "v": self.pool.v, "table": table}

    def _prefilled_state(self, table, n_blocks, cache_len, logits, *,
                         cache=None) -> GenState:
        B = logits.shape[0]
        return GenState(
            table=table, n_blocks=n_blocks, cache_len=cache_len,
            pending_logits=logits.float(),
            done=torch.zeros((B,), dtype=torch.bool, device=self.device),
            logprob_sum=torch.zeros((B,), device=self.device),
            n_gen=torch.zeros((B,), dtype=torch.int32, device=self.device),
            cache=cache)

    def _prefill_with_prefix(self, tokens, lens_h, cached_table,
                             cached_lens) -> GenState:
        """Host planning for a cached-prefix partial prefill: build each
        row's full block table (cached blocks, tail CoW, fresh suffix
        blocks), then run the suffix-only device pass.

        Every misaligned row's partly used cached tail block is
        copy-on-written in one ``pool.cow`` call and every fresh suffix
        block comes from one ``pool.alloc``.  The whole need is reserved
        up front, so an :class:`OutOfBlocks` raise leaves pool and leases
        untouched."""
        B = tokens.shape[0]
        bs = self.pool.block_size
        cach_h = np.asarray(cached_lens, np.int64).ravel()
        if cach_h.shape[0] != B:
            raise ValueError(f"cached_lens has {cach_h.shape[0]} rows for a "
                             f"batch of {B}")
        if (lens_h < 1).any():
            raise ValueError("cached-prefix prefill needs >= 1 suffix token "
                             "per row (the next-token logits come from the "
                             "suffix)")
        totals = cach_h + lens_h
        if (totals > self.max_len - 1).any():
            raise ValueError(
                f"cached + suffix length ({int(totals.max())}) overruns the "
                f"usable sequence length {self.max_len - 1}")
        ctab = np.asarray(cached_table, np.int64)
        n_full = cach_h // bs
        rem = cach_h % bs
        n_tot = np.array([blocks_for(t, bs) for t in totals])
        # tail CoW (one per misaligned row) + fresh suffix blocks
        n_new = n_tot - (n_full + (rem > 0))
        needed = int(n_new.sum() + (rem > 0).sum())
        if not self.pool.reserve(needed):
            raise OutOfBlocks(needed, self.pool.free_blocks)
        table = np.zeros((B, self.table_width), np.int32)
        for i in range(B):
            table[i, :n_full[i]] = ctab[i, :n_full[i]]
        # each misaligned row's lease on its cached tail moves to a private
        # copy (cow drops one source reference per block), which the
        # suffix scatter then extends at offsets [rem, bs)
        cow_rows = [i for i in range(B) if rem[i]]
        new_tails = self.pool.cow([int(ctab[i, n_full[i]])
                                   for i in cow_rows])
        for i, nt in zip(cow_rows, new_tails):
            table[i, n_full[i]] = nt
        fresh = self.pool.alloc(int(n_new.sum())) if n_new.any() else []
        off = 0
        for i in range(B):
            if n_new[i]:
                have = int(n_full[i] + (1 if rem[i] else 0))
                table[i, have:n_tot[i]] = fresh[off:off + int(n_new[i])]
                off += int(n_new[i])
        # gather only the columns some row has cached (the batch max)
        prefix_w = max(1, int(-(-int(cach_h.max()) // bs)))
        cache = self._paged_handle(table)
        tr = self.tracer
        t0 = tr.now() if tr is not None else 0.0
        prefix = self._gather_prefix(cache["table"],
                                     self._vec(cach_h, torch.int32),
                                     prefix_w=prefix_w)
        if tr is not None:
            tr.span("gather", t0, prefix_w=prefix_w)
        logits = self.model.prefill(self.params, tokens, self.cfg,
                                    lengths=self._vec(lens_h, torch.int32),
                                    paged=cache, prefix=prefix)
        return self._prefilled_state(table, n_tot.astype(np.int32),
                                     self._vec(totals, torch.int32), logits)

    def _gather_prefix(self, table: torch.Tensor, lens: torch.Tensor, *,
                       prefix_w: int) -> dict:
        """Gather the first ``prefix_w`` table columns of every row from
        the stacked pool leaves (L, n_blocks, bs, ...) into a dense
        (L, B, prefix_w * bs, Hkv, D) prefix view, dequantized once for K
        and once for V through ``ops.lut_dequant_gather``.  Slots past a
        row's cached length are masked inside ``forward`` via ``lens``."""
        from repro_torch.kernels import ops

        ptab = table[:, :prefix_w].long()

        def leaf(a):
            g = a[:, ptab]  # (L, B, prefix_w, bs, *slab)
            return g.reshape(g.shape[0], g.shape[1], -1, *g.shape[4:])

        def gather(pool):
            if isinstance(pool, dict):
                pool = {name: leaf(a) for name, a in pool.items()}
            else:
                pool = leaf(pool)
            return ops.lut_dequant_gather(pool)

        return {"k": gather(self.pool.k), "v": gather(self.pool.v),
                "len": lens}

    def empty_state(self, batch: int) -> GenState:
        """An all-free decoding state of ``batch`` rows (every row done,
        holding zero blocks, or zeroed dense rows) — the scheduler's
        persistent slot state."""
        if not self.paged:
            return GenState(
                table=None, n_blocks=None,
                cache=self.model.init_cache(self.cfg, batch, self.max_len,
                                            device=self.device),
                **self._free_vectors(batch))
        return GenState(
            table=np.zeros((batch, self.table_width), np.int32),
            n_blocks=np.zeros((batch,), np.int32),
            **self._free_vectors(batch))

    def _free_vectors(self, batch: int) -> dict:
        return dict(
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
        place on ``dst``'s tensors).  Paged: the overwritten ``dst`` rows
        must already be released: block ownership moves from ``src`` rows
        to ``dst`` rows without touching refcounts.  Dense: every cache
        leaf's rows are copied (batch is axis 1 of each leaf: KV slots,
        conv and SSM states)."""
        rows_h = np.asarray(rows, np.int64).ravel()
        r = self._vec(rows_h, torch.long)
        if self.paged:
            dst.table[rows_h] = src.table
            dst.n_blocks[rows_h] = src.n_blocks
        else:
            for name, leaf in dst.cache.items():
                leaf[:, r] = src.cache[name].to(leaf.dtype)
        for name in ("cache_len", "pending_logits", "done", "logprob_sum",
                     "n_gen"):
            getattr(dst, name)[r] = getattr(src, name)
        return dst

    def release_rows(self, state: GenState, rows) -> GenState:
        """Mark ``rows`` done and, paged, free their blocks back to the
        pool (tables re-pointed at the scratch block)."""
        rows = np.asarray(rows, np.int64).ravel()
        for r in rows if self.paged else ():
            self.pool.release(state.table[r, :state.n_blocks[r]])
            state.table[r] = 0
            state.n_blocks[r] = 0
        if rows.size:
            state.done[self._vec(rows, torch.long)] = True
        return state

    def fork(self, state: GenState, n: int) -> GenState:
        """Replicate each row n times (row i -> rows [i*n, (i+1)*n)).
        Paged: bumps the refcount of every owned block and repeats the
        table row, so no KV block is allocated or copied.  Dense: copies
        each row's KV n times."""

        def rep(x, dim=0):
            return x.repeat_interleave(n, dim=dim)

        if not self.paged:
            return GenState(
                table=None, n_blocks=None,
                cache={k: rep(v, 1) for k, v in state.cache.items()},
                cache_len=rep(state.cache_len),
                pending_logits=rep(state.pending_logits),
                done=rep(state.done), logprob_sum=rep(state.logprob_sum),
                n_gen=rep(state.n_gen))
        if n > 1:
            for i in range(state.table.shape[0]):
                self.pool.retain(state.table[i, :state.n_blocks[i]],
                                 times=n - 1)
        return GenState(
            table=np.repeat(state.table, n, axis=0),
            n_blocks=np.repeat(state.n_blocks, n, axis=0),
            cache_len=rep(state.cache_len),
            pending_logits=rep(state.pending_logits), done=rep(state.done),
            logprob_sum=rep(state.logprob_sum), n_gen=rep(state.n_gen))

    def reorder(self, state: GenState, idx) -> GenState:
        """Gather rows by ``idx`` (beam-search survivor commit).  Paged:
        the block tables are gathered and refcounts fixed — rows ``idx``
        drops release their blocks, rows it takes k times gain k - 1
        references (their copies then diverge by copy-on-write).  Dense:
        the gathered rows' KV is copied."""
        idx_h = np.asarray(idx.cpu() if torch.is_tensor(idx) else idx,
                           np.int64).ravel()
        i = self._vec(idx_h, torch.long)
        if not self.paged:
            return GenState(
                table=None, n_blocks=None,
                cache={k: v[:, i] for k, v in state.cache.items()},
                cache_len=state.cache_len[i],
                pending_logits=state.pending_logits[i], done=state.done[i],
                logprob_sum=state.logprob_sum[i], n_gen=state.n_gen[i])
        counts = np.bincount(idx_h, minlength=state.table.shape[0])
        for r in range(state.table.shape[0]):
            owned = state.table[r, :state.n_blocks[r]]
            if counts[r] == 0:
                self.pool.release(owned)
            elif counts[r] > 1:
                self.pool.retain(owned, times=int(counts[r]) - 1)
        return GenState(
            table=state.table[idx_h], n_blocks=state.n_blocks[idx_h],
            cache_len=state.cache_len[i],
            pending_logits=state.pending_logits[i], done=state.done[i],
            logprob_sum=state.logprob_sum[i], n_gen=state.n_gen[i])

    def resume(self, state: GenState) -> GenState:
        """Clear every done flag (step-level beam search continues its
        beams after a step-delimiter stop)."""
        return dataclasses.replace(state,
                                   done=torch.zeros_like(state.done))

    def freeze_rows(self, state: GenState, rows) -> GenState:
        """Mark ``rows`` done without freeing their blocks: they stop
        advancing (writes routed to scratch, pending logits frozen) but
        keep their KV.  The scheduler freezes beam lanes that exhaust a
        step's token budget until the whole tree reaches its scoring
        boundary; :meth:`resume_rows` re-arms them."""
        return self._set_done(state, rows, True)

    def resume_rows(self, state: GenState, rows) -> GenState:
        """Clear the done flags of ``rows`` only (other rows, e.g. idle
        scheduler slots, keep theirs)."""
        return self._set_done(state, rows, False)

    def _set_done(self, state: GenState, rows, value: bool) -> GenState:
        done = state.done.clone()
        done[self._vec(np.asarray(rows, np.int64).ravel(), torch.long)] = \
            value
        return dataclasses.replace(state, done=done)

    # -- paged block bookkeeping ---------------------------------------------
    def prepare_decode(self, state: GenState, n_steps: int = 1,
                       clamp: bool = False) -> GenState:
        """Host-side block planning before decoding ``n_steps`` tokens.

        For every live row: allocate the blocks its next writes land in,
        and copy-on-write any still-shared block at or past the write
        frontier (post-fork tail blocks).  The whole plan is committed
        only if the free list covers it, so an :class:`OutOfBlocks` raise
        leaves pool and state untouched.  No-op on the dense layout.

        ``clamp=True`` caps each row's plan at the usable sequence length
        instead of raising: a speculative verify plans ``n_steps``
        positions for every row, and a row near its budget has its
        over-length proposals routed to the unattended last slot (never
        committed: the scheduler caps proposals to the remaining
        budget)."""
        if not self.paged:
            return state
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
            if clamp:
                last = min(last, self.max_len - 2)
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
             sc: SamplerConfig = SamplerConfig(), stop_ids: tuple = (),
             row_stops=None, canary: bool = False, trace_core: bool = True,
             graph: bool = False):
        """One decode step.  Returns (new_state, sampled tokens (B,)).

        ``row_stops`` (B,) adds one stop id per row on top of the shared
        ``stop_ids`` (-1: none): the scheduler stops beam lanes at their
        step delimiter while chat rows in the same batch decode through
        it.  Runs :meth:`prepare_decode` first (may raise
        :class:`OutOfBlocks`; a ``plan`` span with a tracer), then
        samples from the pending logits and scatters this step's KV into
        the pool in place (a ``decode`` phase with a profiler).

        ``canary=True`` (paged only) first runs the same step through the
        exact path (:meth:`_canary_step`) and keeps its logits in
        :attr:`last_canary_logits` for the scheduler's drift
        comparison.  ``trace_core=False`` records no ``sample`` or
        ``forward`` span (a speculative round's self-draft steps).
        ``graph=True`` (the scheduler's plain step) lets the forward
        replay the engine's CUDA graph (:meth:`_graph_for`)."""
        tr = self.tracer
        if tr is not None:
            t0 = tr.now()
            state = self.prepare_decode(state)
            tr.span("plan", t0)  # CoW/alloc host planning
        else:
            state = self.prepare_decode(state)
        if canary:
            self.last_canary_logits = self._canary_step(
                state, generator, sc, stop_ids, row_stops)
        prof = self.profiler
        pt0 = prof.phase_begin("decode") if prof is not None else 0.0
        st, tok = self._step_core(state, generator, sc, stop_ids, row_stops,
                                  trace_core=trace_core, graph=graph)
        if prof is not None:
            prof.phase_end("decode", pt0, outputs=(tok, st.pending_logits))
        return st, tok

    def _canary_step(self, state: GenState, generator, sc: SamplerConfig,
                     stop_ids: tuple, row_stops=None) -> torch.Tensor:
        """Exact-path replica of the paged decode step, run on the planned
        state just before the production step: the ``"plain"``
        paged-attention impl (table gather, the pool's plain dequant, f32
        softmax), so its logits are the drift-free reference for
        whatever approximated path production runs.  Returns the replica's
        next pending logits and commits nothing.

        It samples the token production will sample: from a copy of
        ``generator`` (or, with none, inside a forked global RNG), so the
        production generator is never drawn from.  Its one in-place
        effect, the token's KV write into the pool, lands on the slots
        production then writes; the K/V projections do not read the
        attention impl, and each token slab is quantized alone, so
        production overwrites it with its own bytes and finds the pool as
        it would have.  The dispatch hook is muted (verification, not
        production work) and the impl restored in ``finally``."""
        from repro_torch.kernels import ops
        from repro_torch.models import layers

        if generator is not None:
            gen = torch.Generator(device=generator.device)
            gen.set_state(generator.get_state())
            rng = contextlib.nullcontext()
        else:
            gen = None
            rng = torch.random.fork_rng(
                devices=[self.device] if self.device.type == "cuda" else [])
        prev = layers.set_paged_attention_impl(layers.PLAIN_IMPL)
        prev_hook = ops.set_op_hook(None)
        try:
            with rng:
                st, _tok = self._step_core(state, gen, sc, stop_ids,
                                           row_stops, trace_core=False)
        finally:
            ops.set_op_hook(prev_hook)
            layers.set_paged_attention_impl(prev)
        return st.pending_logits

    def kv_roundtrip_error(self, max_blocks: int = 4):
        """Per-layer KV quantization round-trip error over a sample of
        live pool blocks: ``max |dequant(quant(dequant(pool))) -
        dequant(pool)|`` per layer, K and V leaves combined.  A stable
        quantizer round-trips its own output exactly (error 0.0); drift
        here means the stored codes sit on decision boundaries the
        re-quantization resolves differently, the online proxy for §5.1
        drift when no fp reference exists.  Returns None on fp pools."""
        from repro_torch.serving.kv_quant import (dequantize_kv, kv_geometry,
                                                  quantize_kv)

        pool = self.pool
        if pool is None or not isinstance(pool.k, dict):
            return None
        live = np.nonzero(pool.refcount > 0)[0][:max_blocks]
        if live.size == 0:
            return None
        idx = torch.as_tensor(live, dtype=torch.long, device=self.device)
        per_layer = None
        for leaf in (pool.k, pool.v):
            sub = {name: a[:, idx] for name, a in leaf.items()}
            mode, gr, gc, _ = kv_geometry(sub)
            x = dequantize_kv(sub)
            x2 = dequantize_kv(quantize_kv(x, mode=mode, gr=gr, gc=gc))
            err = (x2 - x).abs().flatten(1).amax(dim=1)      # (L,)
            per_layer = err if per_layer is None \
                else torch.maximum(per_layer, err)
        return [float(e) for e in per_layer.cpu()]

    def _step_core(self, state: GenState, generator, sc: SamplerConfig,
                   stop_ids: tuple, row_stops=None, trace_core: bool = True,
                   graph: bool = False):
        """Sample, stop and decode one step over already planned blocks.
        With a tracer and ``trace_core``, a ``sample`` span (its device
        time timed on a CUDA engine) and a ``forward`` span whose
        ``graph`` arg says whether the forward was replayed."""
        stop_ids = tuple(stop_ids) or (self.eos_id,)
        tr = self.tracer if trace_core else None
        if tr is not None:
            t0, ev0 = tr.now(), cuda_mark(self.device)
        tok = sample(state.pending_logits, generator, sc)
        lp = logprobs_of(state.pending_logits, tok)
        tok = torch.where(state.done, self.pad_id, tok).to(torch.int32)
        new_done = state.done.clone()
        for s in stop_ids:
            new_done |= tok == s
        if row_stops is not None:
            new_done |= tok == self._vec(row_stops, torch.int32)
        new_len = torch.where(state.done, state.cache_len,
                              state.cache_len + 1)
        # done rows route their discarded write to position max_len - 1,
        # which the table maps to the scratch block or an unattended final
        # offset (usable sequence length is max_len - 1)
        model_len = torch.where(state.done, self.max_len, new_len).to(
            torch.int32)
        if tr is not None:
            ev1 = cuda_mark(self.device)
            sp = tr.span("sample", t0)
            if ev0 is not None:
                tr.time_on_device(sp, ev0, ev1)
        g = self._graph_for(state) if graph else None
        if g is None:
            logits = self._decode(tok, self._cache(state), model_len,
                                  state.done)
        else:
            logits = g.run(tok, model_len, state.table)
        if tr is not None:
            tr.span("forward", sp.t1, graph=g is not None)
        # done rows keep the logits that followed their stop token, so
        # resume() continues from them (a fresh tensor: a replay's logits
        # buffer is overwritten by the next one)
        pending = torch.where(state.done[:, None], state.pending_logits,
                              logits.float())
        return GenState(
            table=state.table, n_blocks=state.n_blocks, cache=state.cache,
            cache_len=new_len.to(torch.int32), pending_logits=pending,
            done=new_done,
            logprob_sum=state.logprob_sum + torch.where(
                state.done, torch.zeros_like(lp), lp),
            n_gen=state.n_gen + (~state.done).to(torch.int32)), tok

    def _graph_for(self, state: GenState) -> Optional[DecodeGraph]:
        """The CUDA graph this step's forward replays, or None to run it
        eager.  A graph replays only where the engine is paged (so a
        transformer) on a CUDA device, no ``ops`` hook is installed (the
        profiler attributes each call), the paged-attention impl is a
        kernel's, and the step has the captured batch width, impl and
        pool leaves.  Nothing here reads a knob: the step's shape and the
        engine's state decide.

        The first such step runs eager (every kernel launches, and
        builds, once); the next one at the same width and impl captures
        the graph, once per engine.  After that a step that differs runs
        eager: it never captures again."""
        from repro_torch.kernels import ops
        from repro_torch.models import layers

        if not self.paged or not DecodeGraph.available(self.device) or \
                ops.op_hook() is not None:
            return None
        impl = layers.paged_attention_impl()
        if impl not in layers.PAGED_ATTN_IMPLS:
            return None
        batch = state.table.shape[0]
        if self._graph is not None:
            ok = self._graph.matches(batch, impl, pool_pointers(self.pool))
            return self._graph if ok else None
        if self._graph_warm != (batch, impl):
            self._graph_warm = (batch, impl)
            return None
        return self._capture(batch, impl)

    def _capture(self, batch: int, impl: str) -> DecodeGraph:
        """Capture the paged decode forward at ``batch`` rows (a
        ``capture`` span with a tracer)."""
        tr = self.tracer
        t0 = tr.now() if tr is not None else 0.0
        g = DecodeGraph(batch=batch, width=self.table_width,
                        device=self.device, impl=impl,
                        pointers=pool_pointers(self.pool))
        g.capture(lambda tok, table, model_len: self._decode(
            tok, self._pool_handle(table), model_len, None))
        self._graph = g
        if tr is not None:
            tr.span("capture", t0, batch=batch, width=self.table_width)
        return g

    def _decode(self, tok, cache: dict, model_len, done) -> torch.Tensor:
        """The model's decode step over ``cache`` in place.  Recurrent
        states (a Mamba2 model's conv and ssm) have no scratch slot: done
        rows keep theirs unchanged (``keep=``), as the JAX engine restores
        them by ``where`` after its step."""
        kw = {"keep": done} if "ssm" in cache else {}
        return self.model.decode_step(self.params, tok[:, None], cache,
                                      model_len, self.cfg, **kw)

    def generate(self, state: GenState, n_steps: int,
                 generator: Optional[torch.Generator],
                 sc: SamplerConfig = SamplerConfig(), stop_ids: tuple = ()):
        """Decode ``n_steps`` tokens (each row stopping at any id in
        ``stop_ids``, default EOS).  Returns (final state, (B, n_steps)
        int32 tokens, pad_id after a row's stop).

        Blocks for the whole horizon are planned (and shared tails
        copy-on-written) once up front, as the JAX package does before its
        scan, so the steps write in place with no per-step planning; rows
        that stop early keep their surplus blocks until released."""
        state = self.prepare_decode(state, n_steps)
        toks = []
        for _ in range(n_steps):
            state, tok = self._step_core(state, generator, sc, stop_ids,
                                         trace_core=False)
            toks.append(tok)
        if not toks:
            return state, torch.zeros((state.done.shape[0], 0),
                                      dtype=torch.int32, device=self.device)
        return state, torch.stack(toks, dim=1)

    # -- speculative decoding (draft-then-verify) ----------------------------
    def spec_verify(self, state: GenState, xs, n_prop, row_stops=None,
                    stop_ids: tuple = ()):
        """Commit the longest greedy-agreeing prefix of ``xs`` (B, W) per
        row in one batched forward.  Paged only.

        ``xs[:, 0]`` must be the argmax of ``state.pending_logits`` (what
        a plain greedy step would emit, so a live row always commits at
        least one token); columns 1.. are draft proposals, and ``n_prop``
        (B,) counts each row's valid columns.  Blocks for all W positions
        are planned first (``prepare_decode(clamp=True)``; may raise
        :class:`OutOfBlocks` with state and pool untouched).  The forward
        reads each row's committed prefix through its table (the partial
        prefill's gather, K4 on quantized pools) and writes all W
        proposals' KV at the row's frontier (done rows at the clamped
        last slot).  Token j >= 1 commits iff every earlier proposal
        agreed with the target's argmax, and a committed stop id ends the
        run.  Logprobs: column 0 under the old pending logits, column j
        under the verify logits at j - 1.  Returns ``(new_state,
        commit)``, ``commit`` a host (B, W) 0/1 prefix mask: row i
        committed ``xs[i, :commit[i].sum()]``.  The rejected suffix's
        blocks are reclaimed by :meth:`trim_rows`.  With a tracer the
        block plan is a ``plan`` span and the rest a ``spec_verify``
        span; with a profiler the forward is a ``spec_verify`` phase."""
        if not self.paged:
            raise ValueError("spec_verify requires the paged KV layout "
                             "(DecodeEngine(paged=True))")
        xs = self._vec(xs, torch.int32)
        B, W = xs.shape
        stop_ids = tuple(stop_ids) or (self.eos_id,)
        tr = self.tracer
        t0 = tr.now() if tr is not None else 0.0
        state = self.prepare_decode(state, W, clamp=True)
        if tr is not None:
            tr.span("plan", t0)
        clen, done = state.cache_len, state.done
        clen_h, done_h = clen.cpu().numpy(), done.cpu().numpy()
        # the prefix gather covers the longest live row, block granular
        top = int(clen_h[~done_h].max()) if (~done_h).any() else 1
        prefix_w = max(1, -(-top // self.pool.block_size))
        prof = self.profiler
        t1 = tr.now() if tr is not None else 0.0
        pt0 = prof.phase_begin("spec_verify") if prof is not None else 0.0
        paged = self._paged_handle(state.table)
        prefix = self._gather_prefix(paged["table"], clen,
                                     prefix_w=prefix_w)
        logits, kvs = self.model.forward(self.params, xs, self.cfg,
                                         return_kv=True, prefix=prefix)
        logits = logits.float()                                # (B, W, V)
        self.model.scatter_suffix(
            paged, kvs, torch.where(done, self.max_len, clen))
        tgt = torch.argmax(logits[:, :-1], dim=-1).to(torch.int32)
        ok = torch.cat([torch.ones((B, 1), dtype=torch.long,
                                   device=self.device),
                        torch.cumprod((xs[:, 1:] == tgt).long(), dim=1)],
                       dim=1)
        jidx = torch.arange(W, device=self.device)[None]
        ok = ok * (jidx < self._vec(n_prop, torch.long)[:, None]).long()
        is_stop = torch.zeros_like(xs, dtype=torch.bool)
        for s in stop_ids:
            is_stop |= xs == s
        if row_stops is not None:
            is_stop |= xs == self._vec(row_stops, torch.int32)[:, None]
        stop_commit = ok * is_stop.long()
        before = torch.cumsum(stop_commit, dim=1) - stop_commit
        commit = ok * (before == 0).long() * (~done).long()[:, None]
        a = commit.sum(dim=1)                                  # accepted
        new_done = done | (commit.bool() & is_stop).any(dim=1)
        # the next pending logits follow the last committed token (done
        # rows keep theirs, as in _step_core)
        last = logits[torch.arange(B, device=self.device),
                      torch.clamp(a - 1, 0, W - 1)]
        pending = torch.where(done[:, None], state.pending_logits, last)
        dists = torch.cat([state.pending_logits[:, None], logits[:, :-1]],
                          dim=1)
        lps = torch.gather(torch.log_softmax(dists, dim=-1), -1,
                           xs.long()[..., None])[..., 0]
        new_state = dataclasses.replace(
            state, cache_len=(clen + a).to(torch.int32),
            pending_logits=pending, done=new_done,
            logprob_sum=state.logprob_sum + (lps * commit.float()).sum(1),
            n_gen=(state.n_gen + a).to(torch.int32))
        if prof is not None:
            prof.phase_end("spec_verify", pt0, outputs=(commit, pending))
        commit_h = commit.cpu().numpy().astype(np.int32)
        if tr is not None:
            tr.span("spec_verify", t1, batch=int(B), width=W)
        return new_state, commit_h

    def trim_rows(self, state: GenState, rows) -> GenState:
        """Free the planned but unused tail blocks of ``rows`` after a
        speculative round: blocks past ``blocks_for(cache_len)`` were
        allocated or copy-on-written (private either way) for proposals
        the verify rejected, so releasing them is the whole cost of a
        rejection, no KV moved.  Pass only rows live at verify time.
        No-op on the dense layout."""
        rows = np.asarray(rows, np.int64).ravel()
        if not self.paged or not rows.size:
            return state
        bs = self.pool.block_size
        table, n_blocks = state.table.copy(), state.n_blocks.copy()
        clen = state.cache_len.cpu().numpy()
        for r in rows:
            keep = blocks_for(int(clen[r]), bs)
            if n_blocks[r] > keep:
                self.pool.release(table[r, keep:n_blocks[r]])
                table[r, keep:n_blocks[r]] = 0
                n_blocks[r] = keep
        return dataclasses.replace(state, table=table, n_blocks=n_blocks)

    def spec_snapshot(self, state: GenState, rows) -> GenState:
        """A self-drafting lane: a second state aliasing ``rows``' blocks
        by a refcount bump (a paged fork).  The draft's first divergent
        write copy-on-writes its frontier block, so the target's KV is
        never touched, and ``release_rows`` on the snapshot undoes the
        bump.  Rows not in ``rows`` come back done with empty tables."""
        if not self.paged:
            raise ValueError("spec_snapshot requires the paged KV layout "
                             "(DecodeEngine(paged=True))")
        rows = np.asarray(rows, np.int64).ravel()
        table, n_blocks = state.table.copy(), state.n_blocks.copy()
        mask = np.zeros(table.shape[0], bool)
        mask[rows] = True
        for r in rows:
            self.pool.retain(table[r, :n_blocks[r]])
        table[~mask] = 0
        n_blocks[~mask] = 0
        return dataclasses.replace(
            state, table=table, n_blocks=n_blocks,
            done=state.done | self._vec(~mask, torch.bool))

    def forced_step(self, state: GenState, tok) -> GenState:
        """Feed a given token per row (no sampling): the draft-model
        engine consumes the target's committed token before proposing.
        Logprob and n_gen are untouched.  Dense layout only (the drafter
        is dense; the next round resyncs its whole state)."""
        if self.paged:
            raise ValueError("forced_step supports the dense KV layout "
                             "only (the speculative draft engine)")
        tok = torch.where(state.done, self.pad_id,
                          self._vec(tok, torch.int32)).to(torch.int32)
        new_len = torch.where(state.done, state.cache_len,
                              state.cache_len + 1).to(torch.int32)
        model_len = torch.where(state.done, self.max_len, new_len).to(
            torch.int32)
        logits = self._decode(tok, state.cache, model_len, state.done)
        pending = torch.where(state.done[:, None], state.pending_logits,
                              logits.float())
        return dataclasses.replace(state, cache_len=new_len,
                                   pending_logits=pending)


# ---------------------------------------------------------------------------
# Continuous batching
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BeamSpec:
    """Step-level tree search as a scheduler request class (paper §2.1).

    A request carrying a ``BeamSpec`` occupies ``width * expand`` slots
    ("lanes") that decode like any other rows of the batch.  A lane stops
    at ``step_stop_id`` (the reasoning-step delimiter) or after
    ``step_tokens`` tokens; once every lane has stopped the tree is at a
    scoring boundary: ``score`` ranks all candidates in one batched call,
    the top ``width`` survive, and one ``DecodeEngine.reorder`` commits
    the prune and re-expansion (losing lanes' blocks free, each
    survivor's blocks gain ``expand - 1`` references, no KV copied).
    After ``max_steps`` boundaries (or ``finished`` true on the
    survivors) ``final_score`` picks the answer and the request completes
    with ``width`` samples.  The callbacks take token lists, so the
    scheduler stays tokenizer-agnostic:

    * ``score(token_lists, logprob_sum, n_gen) -> (n,) scores`` (required);
    * ``final_score`` — final selection (defaults to ``score``);
    * ``finished(token_lists) -> bool`` — early exit on the survivors.
    """

    width: int                   # surviving beams per boundary
    expand: int                  # candidates per surviving beam
    step_tokens: int = 16        # token budget per reasoning step
    max_steps: int = 8           # scoring boundaries before final selection
    step_stop_id: int = -1       # step delimiter token id (e.g. '.')
    score: Optional[Callable] = None
    final_score: Optional[Callable] = None
    finished: Optional[Callable] = None

    @property
    def fan(self) -> int:
        """Slots (lanes) the request occupies while decoding."""
        return self.width * self.expand


@dataclass(frozen=True)
class SpecConfig:
    """Speculative decoding mode of the continuous scheduler.

    Each scheduler step becomes a draft-then-verify round: a drafter
    proposes up to ``k`` tokens per eligible row and one batched target
    forward (``DecodeEngine.spec_verify``) commits the longest prefix
    that agrees with what plain greedy decoding would produce, so the
    tokens stay those of plain greedy decoding and only tokens per step
    change.  Exactly one draft source:

    * ``self_draft=True``: the target drafts for itself on a refcounted
      snapshot of its own paged state (no extra weights; every draft
      agrees);
    * ``draft_model="<arch>"``: a small dense model from the configs
      registry (smoke config, vocab aligned to the target) runs k - 1
      cheap decode steps per round.

    Speculation applies under greedy sampling on a paged engine; beam
    lanes and ``Request(no_spec=True)`` rows ride the verify at one token
    per round."""

    k: int = 4                   # max tokens committed per row per round
    draft_model: str = ""        # configs-registry arch of the drafter
    self_draft: bool = False     # target drafts on a forked snapshot

    def __post_init__(self):
        if self.k < 2:
            raise ValueError(f"SpecConfig.k must be >= 2 (k={self.k} "
                             f"proposes nothing beyond the plain step)")
        if bool(self.draft_model) == bool(self.self_draft):
            raise ValueError("SpecConfig needs exactly one draft source: "
                             "draft_model=<arch> or self_draft=True")


@dataclass
class Request:
    req_id: int
    prompt: torch.Tensor         # (S,) int32
    max_new_tokens: int = 64
    n_samples: int = 1           # > 1: TTS fan-out sharing one prefill
    search: Optional[BeamSpec] = None  # beam-search tree request class
    no_spec: bool = False        # opt out of speculative rounds


@dataclass
class CompletedSample:
    """One finished slot occupancy (one sample of one request)."""

    req_id: int
    sample_idx: int
    tokens: list                 # generated ids, stop token excluded
    logprob_sum: float           # cumulative sampled logprob
    n_gen: int                   # tokens sampled incl. any stop token
    finish_reason: str           # "stop" | "length" | "beam"
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
class _BeamRun:
    """Host bookkeeping of one in-flight beam-search request.

    ``rows`` are the ``fan`` slots the tree occupies for its lifetime
    (boundary reorders move KV between them, never out of them).  Lane j
    accumulates its candidate in ``tokens[j]`` (step-delimiter stops
    included); ``step_gen`` / ``stopped`` track each lane's progress
    toward the current scoring boundary."""

    req: Request
    spec: BeamSpec
    rows: list
    tokens: list                 # per-lane generated ids since admission
    step_gen: list               # per-lane tokens sampled this beam step
    stopped: list                # per-lane: reached delimiter or budget
    beam_step: int = 0           # boundaries completed


@dataclass
class StepRecord:
    step: int
    occupancy: int               # rows decoding this step
    admitted: int                # requests admitted this step
    prefill_tokens: int          # prompt tokens prefilled this step
    wall_s: float = 0.0          # host wall time of this step
    # tokens committed this step; None = one per occupied row (a plain
    # step).  A speculative round commits several per row.
    decode_tokens: Optional[int] = None


class SchedulerMetrics:
    """Step-level metrics of the continuous batching loop."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self.records: list[StepRecord] = []
        self.completed_requests = 0
        self.completed_samples = 0
        self.preemptions = 0
        self.wall_s = 0.0
        # prefix cache (zero without one): one lookup per admitted
        # request; a hit served some prefix of the prompt from cached
        # blocks, and prefill_tokens_saved counts the prompt tokens whose
        # prefill was skipped
        self.cache_lookups = 0
        self.cache_hits = 0
        self.prefill_tokens_saved = 0
        self.peak_kv_bytes = 0   # dtype-aware paged KV high-water mark
        self.kv_quant = "none"
        # one entry per admission prefill call: the requests it admitted
        self.admission_batch_sizes: list[int] = []
        # beam search: a boundary is one prune + expand commit, which
        # forks and releases fan - width lanes each; prm_batches counts
        # batched score calls and prm_candidates the candidates they
        # covered (per batch > 1: scoring rides the tree's fan)
        self.beam_boundaries = 0
        self.beam_expansions = 0
        self.beam_prunes = 0
        self.prm_batches = 0
        self.prm_candidates = 0
        # speculative decoding: a round is one draft + verify.
        # draft_tokens counts proposals beyond each eligible row's first
        # token, accepted those the verify committed beyond it;
        # committed / row_steps is every committed token over every
        # (eligible row, round) pair, > 1 iff speculation beat one token
        # per step
        self.spec_rounds = 0
        self.spec_draft_tokens = 0
        self.spec_accepted_tokens = 0
        self.spec_committed_tokens = 0
        self.spec_row_steps = 0
        # per-request latency records (telemetry.RequestLatency), appended
        # at request completion when a Tracer is attached: the histogram
        # behind the summary's ttft / itl / queue_wait percentiles.  Empty
        # without a tracer (those keys then report 0.0); step_time_*
        # comes from StepRecord.wall_s and needs no tracer.
        self.latencies: list[RequestLatency] = []
        # roofline/canary profiler (profiling.KernelProfiler) bound by
        # ContinuousScheduler(profiler=...); summary() merges its keys
        # (NULL_PROFILE_METRICS' zeros without one, so the key set is the
        # same either way)
        self.profiler = None

    def record(self, rec: StepRecord):
        self.records.append(rec)

    def record_prefill(self, batch_size: int):
        """Account one admission prefill call covering ``batch_size``
        requests (a TTS group counts as one request: one prefill,
        forked)."""
        self.admission_batch_sizes.append(batch_size)

    @property
    def prefill_calls(self) -> int:
        return len(self.admission_batch_sizes)

    def summary(self) -> dict:
        steps = len(self.records)
        occ_rows = sum(r.occupancy for r in self.records)
        decode = sum(r.occupancy if r.decode_tokens is None
                     else r.decode_tokens for r in self.records)
        step_ts = [r.wall_s for r in self.records]
        admitted = sum(r.admitted for r in self.records)
        sizes = self.admission_batch_sizes
        # tail latency (seconds); every key survives an admitted == 0
        # drain (percentile is 0.0 on empty input)
        lat = self.latencies
        ttfts = [x.ttft for x in lat]
        waits = [x.queue_wait for x in lat]
        gaps = [g for x in lat for g in x.gaps]
        return {
            "admitted_requests": admitted,
            "prefill_calls": self.prefill_calls,
            "prefill_calls_per_request": (self.prefill_calls / admitted
                                          if admitted else 0.0),
            "admission_batch_max": max(sizes, default=0),
            "admission_batch_avg": (sum(sizes) / len(sizes)
                                    if sizes else 0.0),
            "steps": steps,
            "n_slots": self.n_slots,
            "avg_slot_occupancy": (occ_rows / (steps * self.n_slots)
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
            "prefix_cache_lookups": self.cache_lookups,
            "prefix_cache_hits": self.cache_hits,
            "prefix_cache_hit_rate": (self.cache_hits / self.cache_lookups
                                      if self.cache_lookups else 0.0),
            "prefill_tokens_saved": self.prefill_tokens_saved,
            "peak_kv_bytes": self.peak_kv_bytes,
            "kv_quant": self.kv_quant,
            "beam_boundaries": self.beam_boundaries,
            "beam_expansions": self.beam_expansions,
            "beam_prunes": self.beam_prunes,
            "prm_batches": self.prm_batches,
            "prm_candidates": self.prm_candidates,
            "prm_candidates_per_batch": (self.prm_candidates
                                         / self.prm_batches
                                         if self.prm_batches else 0.0),
            "spec_rounds": self.spec_rounds,
            "draft_tokens": self.spec_draft_tokens,
            "spec_acceptance_rate": (self.spec_accepted_tokens
                                     / self.spec_draft_tokens
                                     if self.spec_draft_tokens else 0.0),
            "accepted_tokens_per_step": (self.spec_committed_tokens
                                         / self.spec_row_steps
                                         if self.spec_row_steps else 0.0),
            "latency_requests": len(lat),
            "ttft_p50": percentile(ttfts, 50),
            "ttft_p90": percentile(ttfts, 90),
            "ttft_p99": percentile(ttfts, 99),
            "itl_p50": percentile(gaps, 50),
            "itl_p99": percentile(gaps, 99),
            "queue_wait_p50": percentile(waits, 50),
            "queue_wait_p99": percentile(waits, 99),
            "preempt_delay_s": sum(x.preempt_delay for x in lat),
            "step_time_p50": percentile(step_ts, 50),
            "step_time_p99": percentile(step_ts, 99),
            **(self.profiler.summary_metrics()
               if self.profiler is not None
               else dict(NULL_PROFILE_METRICS)),
        }


class ContinuousScheduler:
    """Slot-based continuous batching on top of :class:`DecodeEngine`.

    One persistent ``GenState`` of ``n_slots`` rows decodes every step;
    requests flow through slots independently:

    1. **Admit** — while free slots and pool blocks remain, runs of plain
       requests at the queue head share one batched prefill and are
       scattered into free rows; a TTS request (``n_samples > 1``) or a
       beam tree (``search``) does one prefill and ``fork``\\ s into its
       slots.
    2. **Decode** — one batched ``DecodeEngine.step`` over all rows (free
       rows are done and cost an idle lane).
    3. **Release** — a row that samples a stop id or reaches its
       ``max_new_tokens`` frees its slot and blocks immediately.  Beam
       lanes stop at their step delimiter (per-row ``row_stops``) or are
       frozen at their step budget; once a tree's lanes have all
       stopped it is scored, pruned and re-expanded through one
       ``reorder`` (or finished, releasing every lane).

    On a paged engine, when a decode step cannot get its blocks
    (:class:`OutOfBlocks`), the youngest live request is preempted —
    slots released, blocks freed, requeued at the head to rerun from
    scratch — and the step retried.

    With a :class:`~repro_torch.serving.prefix_cache.PrefixCache`
    attached, admission is cache-aware: each request matches the longest
    cached prefix of its prompt, leases those blocks and prefills only
    the uncached suffix (the engine's partial prefill); its full prompt
    blocks are inserted into the tree right after, so a later admission
    in the same step can hit, and completed rows re-insert on release.
    Runs of plain requests at the queue head are matched together,
    bucketed by cached width (``ceil(cached_len / block_size)``) and
    admitted through one batched partial prefill per bucket; a candidate
    that would match a longer prefix once an earlier request of the same
    run has inserted is deferred to the next round of the same step, so
    hits, leases and token counts equal one-at-a-time admission.  The
    cache is the pool's pressure hook, so a block shortage evicts cached
    leaves before it preempts.  One admission prefill carries at most as
    many requests as there are free slots.

    With ``spec=``:class:`SpecConfig`, each decode step under greedy
    sampling is a draft-then-verify round: the drafter (the target on a
    refcounted snapshot, or a small dense registry model whose KV shadows
    the committed context) proposes up to ``spec.k`` tokens per eligible
    row, one ``engine.spec_verify`` commits the longest greedy-agreeing
    prefix, and ``engine.trim_rows`` frees the rejected blocks.  Beam
    lanes and ``no_spec`` rows ride the verify at one token; a round with
    nothing to propose, or a self-draft short of blocks, falls back to
    the plain step.  ``OutOfBlocks`` in the verify preempts and reruns
    the round, the snapshot already released.

    ``tracer`` (:class:`~repro_torch.serving.telemetry.Tracer`) records
    the lifecycle events, phase spans and gauges of the JAX package's
    scheduler, with the same kinds, names and arguments, and the spans
    inside the step that it lacks (``gather``, ``sample``, ``forward``,
    ``readback``; each ``step`` span re-anchors the tracer's Unix
    stamps); ``profiler``
    (:class:`~repro_torch.serving.profiling.KernelProfiler`) attributes
    the kernels' analytic cost per phase, samples phase walls and, on its
    canary steps, holds the decode step against the exact path (a canary
    step is a plain step, never a speculative round).  Both default to
    None: zero overhead, bit-identical outputs.

    On a dense engine (``DecodeEngine(paged=False)``, the only layout of
    the Mamba2 / hybrid families) the scheduler runs as the JAX
    package's: no block budget and no preemption (each slot owns its
    rows for the whole ``max_len``), every prompt padded to
    ``prompt_len``, no canary (the profiler's exact-path replica is a
    paged-attention one); the prefix cache and speculation, block-pool
    operations, are refused.  Best-of-N, plain requests, beam trees, the
    tracer and the profiler run on it.
    """

    def __init__(self, engine: DecodeEngine, n_slots: int = 8,
                 prompt_len: int = 32, stop_ids: tuple = (),
                 prefix_cache: Optional[PrefixCache] = None,
                 tracer: Optional[Tracer] = None, profiler=None,
                 spec: Optional[SpecConfig] = None):
        self.engine = engine
        # the scheduler owns its engine's tracer and profiler slots:
        # constructing one (re)binds them, so the engine's prefill / plan
        # spans and phases land in the same trace and report, and a
        # profiler's dispatch hook is installed.  The step-wall clock is
        # the tracer's, else the profiler's (both injectable), so traced
        # runs are clock-deterministic.
        self.tracer = tracer
        engine.tracer = tracer
        self._clock = (tracer.now if tracer is not None
                       else profiler.now if profiler is not None
                       else time.perf_counter)
        self.profiler = profiler
        engine.profiler = profiler
        if profiler is not None:
            profiler.install()
        self._preempted: set = set()   # req_ids awaiting re-admission
        self._ft_emitted: set = set()  # req_ids whose first_token fired
        self.paged = engine.paged
        self.n_slots = n_slots
        self.prompt_len = prompt_len
        self.stop_ids = tuple(stop_ids) or (engine.eos_id,)
        if prefix_cache is not None:
            if not engine.paged:
                raise ValueError("prefix_cache requires a paged engine "
                                 "(DecodeEngine(paged=True))")
            if prefix_cache.pool is not engine.pool:
                raise ValueError("prefix_cache is bound to a different "
                                 "KVPool than the engine's")
        self.cache = prefix_cache
        if spec is not None and not engine.paged:
            raise ValueError(
                "speculative decoding requires a paged engine "
                "(DecodeEngine(paged=True)): draft lanes and rejected "
                "suffixes are refcount operations on the block pool")
        self.spec = spec
        # draft-model mode: one persistent dense engine whose KV shadows
        # the target's committed context (prompts prefilled at admission,
        # lengths resynced each round, proposals rolled back to the
        # verify's acceptance point).  Random smoke weights from seed 0;
        # callers wanting a useful drafter swap self._draft.params.
        self._draft: Optional[DecodeEngine] = None
        self._draft_state: Optional[GenState] = None
        if spec is not None and spec.draft_model:
            from repro_torch.configs.registry import get_config

            dcfg = get_config(spec.draft_model, smoke=True)
            if dcfg.vocab_size != engine.cfg.vocab_size:
                dcfg = dcfg.with_(vocab_size=engine.cfg.vocab_size)
            dparams = api.get_model(dcfg).init_params(dcfg, seed=0,
                                                      device=engine.device)
            self._draft = DecodeEngine(dparams, dcfg, max_len=engine.max_len,
                                       eos_id=engine.eos_id,
                                       pad_id=engine.pad_id)
            self._draft_state = self._draft.empty_state(n_slots)
        self.queue: deque[Request] = deque()
        self.slots: list[Optional[_Slot]] = [None] * n_slots
        self.state: Optional[GenState] = None   # built on first admission
        self.step_count = 0
        self.completed: dict[int, list[CompletedSample]] = {}
        self._n_samples: dict[int, int] = {}
        self._beams: dict[int, _BeamRun] = {}    # req_id -> in-flight tree
        self.beam_results: dict[int, dict] = {}  # req_id -> final selection
        self.metrics = SchedulerMetrics(n_slots)
        self.metrics.profiler = profiler
        if self.paged:
            self.metrics.kv_quant = engine.pool.mode
            self._block_bytes = engine.pool.block_bytes()

    # -- submission ----------------------------------------------------------
    def submit(self, req: Request):
        if req.req_id in self._n_samples:
            raise ValueError(f"request id {req.req_id} already submitted")
        if req.search is not None:
            spec = req.search
            if req.n_samples != 1:
                raise ValueError(
                    f"request {req.req_id}: search and n_samples > 1 are "
                    f"mutually exclusive (the tree owns its fan-out)")
            if min(spec.width, spec.expand, spec.step_tokens,
                   spec.max_steps) < 1:
                raise ValueError(
                    f"request {req.req_id}: BeamSpec width/expand/"
                    f"step_tokens/max_steps must all be >= 1")
            if spec.score is None:
                raise ValueError(
                    f"request {req.req_id}: BeamSpec.score is required "
                    f"(batched candidate scoring callback)")
            if spec.step_stop_id < 0:
                raise ValueError(
                    f"request {req.req_id}: BeamSpec.step_stop_id must be "
                    f"a valid token id (the reasoning-step delimiter)")
            if spec.fan > self.n_slots:
                raise ValueError(
                    f"request {req.req_id}: beam fan-out width*expand="
                    f"{spec.fan} exceeds n_slots={self.n_slots}")
        elif req.max_new_tokens < 1:
            raise ValueError(f"request {req.req_id}: max_new_tokens must be "
                             f">= 1, got {req.max_new_tokens}")
        if req.n_samples > self.n_slots:
            raise ValueError(f"request {req.req_id}: n_samples="
                             f"{req.n_samples} exceeds n_slots={self.n_slots}")
        plen = int(req.prompt.shape[0])
        if plen > self.prompt_len:
            raise ValueError(f"request {req.req_id}: prompt length {plen} "
                             f"exceeds prompt_len={self.prompt_len}")
        budget = plen + self._max_new(req)
        if budget > self.engine.max_len - 1:
            raise ValueError(
                f"request {req.req_id}: prompt ({plen}) + worst-case new "
                f"tokens ({self._max_new(req)}) = {budget} exceeds engine "
                f"max_len - 1 = {self.engine.max_len - 1}")
        if self.paged:
            worst = self._worst_case_blocks(req)
            if worst > self.engine.pool.capacity:
                raise ValueError(
                    f"request {req.req_id}: worst-case KV footprint "
                    f"({worst} blocks) exceeds pool capacity "
                    f"({self.engine.pool.capacity} blocks)")
        self._n_samples[req.req_id] = (req.search.width if req.search
                                       else max(1, req.n_samples))
        self.queue.append(req)
        if self.tracer is not None:
            self.tracer.event("enqueue", req.req_id, step=self.step_count)

    @staticmethod
    def _fan(req: Request) -> int:
        """Slots the request occupies: beam fan-out, TTS samples, or 1."""
        return req.search.fan if req.search is not None \
            else max(1, req.n_samples)

    @staticmethod
    def _max_new(req: Request) -> int:
        """Worst-case tokens one of the request's rows can generate."""
        if req.search is not None:
            return req.search.max_steps * req.search.step_tokens
        return req.max_new_tokens

    @staticmethod
    def _is_group(req: Request) -> bool:
        """Admitted by one prefill and a fork: a TTS group or a tree."""
        return req.n_samples > 1 or req.search is not None

    def _worst_case_blocks(self, req: Request) -> int:
        """Blocks the request needs alone at full divergence: shared full
        prompt blocks + per-sample tail CoW and growth."""
        bs = self.engine.pool.block_size
        plen = int(req.prompt.shape[0])
        shared = plen // bs
        per_sample = blocks_for(plen + self._max_new(req), bs) - shared
        return shared + self._fan(req) * per_sample

    def _pad(self, prompt):
        out = torch.full((self.prompt_len,), self.engine.pad_id,
                         dtype=torch.int32)
        out[:prompt.shape[0]] = prompt.cpu()
        return out, int(prompt.shape[0])

    def _prompt_blocks(self, req: Request) -> int:
        if not self.paged:
            return 0  # a dense slot owns its rows
        return blocks_for(int(req.prompt.shape[0]),
                          self.engine.pool.block_size)

    # -- admission -----------------------------------------------------------
    def _merge(self, st: GenState, rows: list):
        if self.state is None:
            self.state = self.engine.empty_state(self.n_slots)
        self.state = self.engine.merge_rows(self.state, st, rows)

    def _count_prefill(self, batch_size: int):
        self.metrics.record_prefill(batch_size)

    def _trace_admit(self, req: Request, rows: list,
                     cached_tokens: int = 0) -> None:
        """Emit the request's admit event (readmit after a preemption)
        with its slot rows and, on the cache-aware path, the cached
        prefix length it admitted with."""
        tr = self.tracer
        if tr is None:
            return
        kind = "readmit" if req.req_id in self._preempted else "admit"
        self._preempted.discard(req.req_id)
        tr.event(kind, req.req_id, step=self.step_count,
                 rows=[int(r) for r in rows],
                 cache_hit=bool(cached_tokens),
                 lease_tokens=int(cached_tokens))

    def _admit_plain(self, reqs: list, free: list) -> int:
        """One batched prefill + one merge for a run of plain requests."""
        padded = [self._pad(r.prompt) for r in reqs]
        st = self.engine.prefill(
            torch.stack([t for t, _ in padded]),
            torch.tensor([n for _, n in padded], dtype=torch.int32))
        self._count_prefill(len(reqs))
        rows = [free.pop(0) for _ in reqs]
        self._merge(st, rows)
        for req, r in zip(reqs, rows):
            self.slots[r] = _Slot(req=req, sample_idx=0,
                                  admitted_step=self.step_count)
            self._trace_admit(req, [r])
        return sum(n for _, n in padded)

    def _admit_group(self, req: Request, free: list) -> int:
        """TTS group or beam tree: one batch-1 prefill forked into
        ``_fan(req)`` slots sharing the prompt's blocks until their first
        divergent write."""
        n = self._fan(req)
        toks, length = self._pad(req.prompt)
        st = self.engine.prefill(toks[None],
                                 torch.tensor([length], dtype=torch.int32))
        self._count_prefill(1)
        if n > 1:
            st = self.engine.fork(st, n)
        rows = [free.pop(0) for _ in range(n)]
        self._merge(st, rows)
        for j, r in enumerate(rows):
            self.slots[r] = _Slot(req=req, sample_idx=j,
                                  admitted_step=self.step_count)
        self._trace_admit(req, rows)
        if req.search is not None:
            self._start_beam(req, rows)
        return length

    def _start_beam(self, req: Request, rows: list) -> None:
        n = len(rows)
        self._beams[req.req_id] = _BeamRun(
            req=req, spec=req.search, rows=list(rows),
            tokens=[[] for _ in range(n)], step_gen=[0] * n,
            stopped=[False] * n)

    # -- cache-aware admission -----------------------------------------------
    def _insert_prompt(self, toks: list, table_row) -> None:
        """Record a prompt's full blocks in the prefix cache (the insert
        shared by admission and release)."""
        n_ins = len(toks) // self.engine.pool.block_size
        if n_ins:
            self.cache.insert(toks, np.asarray(table_row)[:n_ins])

    @staticmethod
    def _host_prompt(req: Request) -> list:
        return [int(t) for t in req.prompt.cpu().numpy().ravel()]

    def _prefill_suffixes(self, suffixes: list, blocks: list,
                          clens: list) -> GenState:
        """One prefill of suffixes right-padded to the longest of them:
        partial when any row has a cached prefix, else the plain paged
        prefill (which skips the prefix gather a miss would pay for
        nothing).  The JAX scheduler pads to ``prompt_len`` so jit sees
        one shape; eager execution gains nothing from that, and padding a
        short hit suffix to the full prompt would spend the device time
        the cache saves on padding rows.  An MoE model is the exception:
        its padding tokens route and take expert capacity like the
        others, so it pads to ``prompt_len`` as the JAX scheduler does."""
        width = (self.prompt_len if self.engine.cfg.moe
                 else max(map(len, suffixes)))
        toks = torch.full((len(suffixes), width),
                          self.engine.pad_id, dtype=torch.int32)
        for i, s in enumerate(suffixes):
            toks[i, :len(s)] = torch.tensor(s, dtype=torch.int32)
        lens = torch.tensor([len(s) for s in suffixes], dtype=torch.int32)
        if not any(clens):
            return self.engine.prefill(toks, lens)
        ctab = np.zeros((len(suffixes), self.engine.table_width), np.int32)
        for i, b in enumerate(blocks):
            ctab[i, :len(b)] = b
        return self.engine.prefill(toks, lens, cached_table=ctab,
                                   cached_lens=np.array(clens, np.int64))

    def _count_lookup(self, clen: int) -> None:
        self.metrics.cache_lookups += 1
        if clen:
            self.metrics.cache_hits += 1
            self.metrics.prefill_tokens_saved += clen

    def _admit_cached_group(self, req: Request, free: list) -> int:
        """Cache-aware admission of one TTS group or beam tree: match,
        lease, one partial prefill of the uncached suffix, insert the
        prompt's full blocks, fork into ``_fan(req)`` slots.  Returns the suffix tokens
        prefilled, or -1 when the pool cannot cover the group's new blocks
        even after eviction (the head then waits, holding no lease)."""
        toks = self._host_prompt(req)
        plen = len(toks)
        # at least one suffix token must be recomputed for the logits
        blocks, clen = self.cache.match(toks[:plen - 1])
        need = blocks_for(plen, self.engine.pool.block_size) - \
            clen // self.engine.pool.block_size
        if not self.engine.pool.reserve(need):
            if blocks:
                self.engine.pool.release(blocks)  # abandon the lease
            return -1
        suffix = toks[clen:]
        st = self._prefill_suffixes([suffix], [blocks], [clen])
        self._count_prefill(1)
        self._count_lookup(clen)
        self._insert_prompt(toks, st.table[0])
        n = self._fan(req)
        if n > 1:
            st = self.engine.fork(st, n)
        rows = [free.pop(0) for _ in range(n)]
        self._merge(st, rows)
        for j, r in enumerate(rows):
            self.slots[r] = _Slot(req=req, sample_idx=j,
                                  admitted_step=self.step_count)
        self._trace_admit(req, rows, cached_tokens=clen)
        if req.search is not None:
            self._start_beam(req, rows)
        return len(suffix)

    def _collect_cached_run(self, free: list) -> list:
        """Pop a run of plain requests off the queue head for one batched
        cache-aware admission round, leasing each as it is collected.
        Entries are {"req", "toks", "blocks", "clen"}.

        Stops at a TTS group, the free-slot count, a request the pool cannot
        cover even after eviction (it stays at the head, holding no
        lease), or a deferral: a candidate that would match a longer
        prefix after an earlier same-run request's insert than the tree
        holds now (``probe`` against ``potential_match``).  Block
        reservations are cumulative across the run."""
        bs = self.engine.pool.block_size
        entries: list[dict] = []
        pending = 0  # new blocks already promised to earlier entries
        while (self.queue and not self._is_group(self.queue[0])
               and len(entries) < len(free)):
            req = self.queue[0]
            toks = self._host_prompt(req)
            plen = len(toks)
            if entries:
                probe = self.cache.probe(toks[:plen - 1])
                if any(self.cache.potential_match(toks[:plen - 1],
                                                  e["toks"]) > probe
                       for e in entries):
                    break  # defer: a same-run insert will serve it better
            blocks, clen = self.cache.match(toks[:plen - 1])
            need = blocks_for(plen, bs) - clen // bs
            if not self.engine.pool.reserve(pending + need):
                if blocks:
                    self.engine.pool.release(blocks)  # abandon the lease
                break  # FIFO: the head waits for blocks
            pending += need
            self.queue.popleft()
            entries.append({"req": req, "toks": toks, "blocks": blocks,
                            "clen": clen})
        return entries

    def _admit_cached_rows(self, entries: list, free: list) -> int:
        """Admit one collected run: one batched prefill per cached-width
        bucket (misses, width 0, through the plain paged prefill), then
        one ``insert_batch`` of the bucket's prompts.  Returns the suffix
        tokens prefilled."""
        bs = self.engine.pool.block_size
        buckets: dict[int, list[dict]] = {}
        for e in entries:
            buckets.setdefault(-(-e["clen"] // bs), []).append(e)
        suffix_tokens = 0
        for wc in sorted(buckets):
            group = buckets[wc]
            suffixes = [e["toks"][e["clen"]:] for e in group]
            st = self._prefill_suffixes(suffixes, [e["blocks"] for e in group],
                                        [e["clen"] for e in group])
            self._count_prefill(len(group))
            self.cache.insert_batch(
                (e["toks"], st.table[i, :len(e["toks"]) // bs])
                for i, e in enumerate(group))
            rows = [free.pop(0) for _ in group]
            self._merge(st, rows)
            for e, r in zip(group, rows):
                self.slots[r] = _Slot(req=e["req"], sample_idx=0,
                                      admitted_step=self.step_count)
                self._trace_admit(e["req"], [r], cached_tokens=e["clen"])
                self._count_lookup(e["clen"])
            suffix_tokens += sum(len(x) for x in suffixes)
        return suffix_tokens

    def _admit_cached(self, free: list) -> tuple:
        admitted = prefill_tokens = 0
        while self.queue and free:
            head = self.queue[0]
            if self._fan(head) > len(free):
                break  # FIFO: the group waits for enough free slots
            if self._is_group(head):
                got = self._admit_cached_group(head, free)
                if got < 0:
                    break  # FIFO: the head waits for blocks
                self.queue.popleft()
                admitted += 1
                prefill_tokens += got
                continue
            entries = self._collect_cached_run(free)
            if not entries:
                break  # FIFO: the head waits for blocks
            prefill_tokens += self._admit_cached_rows(entries, free)
            admitted += len(entries)
        return admitted, prefill_tokens

    def _admit(self) -> tuple:
        """Fill free slots from the queue (FIFO).  Admission stops when the
        head does not fit the free slots or the pool's free blocks (decode
        growth is handled by preemption, not reservation).  With a prefix
        cache, admission goes through the cache-aware path.  Returns
        (requests admitted, prompt tokens prefilled)."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        if self.cache is not None:
            return self._admit_cached(free)
        admitted = prefill_tokens = 0
        # dense rows take no blocks (_prompt_blocks is 0)
        blk_budget = self.engine.pool.free_blocks if self.paged else 0
        while self.queue and free:
            head = self.queue[0]
            if self._fan(head) > len(free):
                break  # FIFO: the group waits for enough free slots
            if self._prompt_blocks(head) > blk_budget:
                break  # FIFO: the head waits for blocks to free up
            if self._is_group(head):
                req = self.queue.popleft()
                blk_budget -= self._prompt_blocks(req)
                prefill_tokens += self._admit_group(req, free)
                admitted += 1
                continue
            plain = []
            while (self.queue and not self._is_group(self.queue[0])
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
        tr = self.tracer
        if tr is not None:
            tr.event("release", slot.req.req_id, step=self.step_count,
                     rows=[int(row)], reason=reason)
        if len(done) == max(1, slot.req.n_samples):
            self.metrics.completed_requests += 1
            if tr is not None:
                # complete: its latency record closes on this release
                self.metrics.latencies.append(
                    tr.request_latency(slot.req.req_id))
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
        # the rerun regenerates every sample (deterministic under greedy);
        # a tree drops its in-flight search the same way and restarts it
        # from the prompt
        self._beams.pop(victim, None)
        dropped = self.completed.pop(victim, [])
        self.metrics.completed_samples -= len(dropped)
        self.queue.appendleft(req)
        self.metrics.preemptions += 1
        if self.tracer is not None:
            self.tracer.event("preempt", victim, step=self.step_count,
                              rows=[int(r) for r in rows])
            self._preempted.add(victim)
            # the rerun decodes its first token afresh: re-arm the event
            self._ft_emitted.discard(victim)

    # -- beam-search trees ---------------------------------------------------
    def _row_stops(self):
        """Per-row extra stop ids of a decode step: each tree's lanes stop
        at its step delimiter, every other row gets -1 (none); None when
        no tree is in flight."""
        if not self._beams:
            return None
        stops = np.full((self.n_slots,), -1, np.int32)
        for run in self._beams.values():
            stops[run.rows] = run.spec.step_stop_id
        return stops

    def _beam_track(self, toks_h, done_h) -> tuple:
        """Advance every tree's host bookkeeping after a decode step.
        Returns (rows to freeze, runs at their scoring boundary): a lane
        that exhausts its step budget without sampling the delimiter is
        frozen (done on the device, blocks kept) while its siblings finish
        their step."""
        tr = self.tracer
        to_freeze: list = []
        boundaries: list = []
        for run in self._beams.values():
            advanced = False
            for j, r in enumerate(run.rows):
                if run.stopped[j]:
                    continue
                advanced = True
                run.tokens[j].append(int(toks_h[r]))
                run.step_gen[j] += 1
                if bool(done_h[r]):      # sampled the delimiter or a stop
                    run.stopped[j] = True
                elif run.step_gen[j] >= run.spec.step_tokens:
                    run.stopped[j] = True
                    to_freeze.append(r)
            if advanced and tr is not None:
                tr.event("token", run.req.req_id, step=self.step_count)
            if all(run.stopped):
                boundaries.append(run)
        return to_freeze, boundaries

    def _beam_boundary(self, run: _BeamRun) -> None:
        """Scoring boundary: one batched score call over all fan
        candidates, then final selection or a prune + expand commit.

        The commit is one ``engine.reorder`` whose index is the identity
        outside the tree's rows and maps lane j to survivor ``keep[j //
        expand]`` inside them, so the pool's refcount fix-up is the tree
        update: losing lanes' blocks free, each survivor's blocks gain
        ``expand - 1`` references and later diverge by copy-on-write."""
        spec, rows = run.spec, run.rows
        tr = self.tracer
        lp = self.state.logprob_sum.cpu().numpy()
        ng = self.state.n_gen.cpu().numpy()
        t0 = tr.now() if tr is not None else 0.0
        scores = np.asarray(
            spec.score([list(t) for t in run.tokens], lp[rows], ng[rows]),
            np.float64).ravel()
        if tr is not None:
            tr.span("prm", t0, step=self.step_count, candidates=len(rows))
        self.metrics.prm_batches += 1
        self.metrics.prm_candidates += len(rows)
        # stable: ties keep the lowest lane, as the direct path's argsort
        keep = np.argsort(-scores, kind="stable")[:spec.width]
        run.beam_step += 1
        self.metrics.beam_boundaries += 1
        if tr is not None:
            tr.event("beam_boundary", run.req.req_id, step=self.step_count,
                     boundary=run.beam_step)
        survivors = [list(run.tokens[int(k)]) for k in keep]
        if run.beam_step >= spec.max_steps or (
                spec.finished is not None and spec.finished(survivors)):
            self._finish_beam(run, keep, survivors, lp, ng)
            return
        idx = np.arange(self.n_slots, dtype=np.int64)
        for j in range(len(rows)):
            idx[rows[j]] = rows[int(keep[j // spec.expand])]
        self.state = self.engine.reorder(self.state, idx)
        self.metrics.beam_expansions += len(rows) - spec.width
        self.metrics.beam_prunes += len(rows) - spec.width
        run.tokens = [list(survivors[j // spec.expand])
                      for j in range(len(rows))]
        run.step_gen = [0] * len(rows)
        run.stopped = [False] * len(rows)
        self.state = self.engine.resume_rows(self.state, rows)
        if tr is not None:
            tr.event("resume", run.req.req_id, step=self.step_count,
                     rows=[int(r) for r in rows])

    def _finish_beam(self, run: _BeamRun, keep, survivors, lp, ng) -> None:
        """Final selection: score the ``width`` survivors, record the
        choice in ``beam_results``, emit one ``CompletedSample`` per
        survivor and release every lane's blocks."""
        spec, rows, req = run.spec, run.rows, run.req
        tr = self.tracer
        final = spec.final_score or spec.score
        krows = [rows[int(k)] for k in keep]
        t0 = tr.now() if tr is not None else 0.0
        final_scores = np.asarray(final(survivors, lp[krows], ng[krows]),
                                  np.float64).ravel()
        if tr is not None:
            tr.span("prm", t0, step=self.step_count,
                    candidates=len(survivors))
        self.metrics.prm_batches += 1
        self.metrics.prm_candidates += len(survivors)
        if self.cache is not None:
            # the tree's full prompt blocks sit below every lane's write
            # frontier (never copy-on-written): reusable by later requests
            self._insert_prompt(self._host_prompt(req),
                                self.state.table[rows[0]])
        first = self.slots[rows[0]]
        self.state = self.engine.release_rows(self.state, rows)
        done_list = self.completed.setdefault(req.req_id, [])
        for j, k in enumerate(keep):
            r = rows[int(k)]
            done_list.append(CompletedSample(
                req_id=req.req_id, sample_idx=j, tokens=list(survivors[j]),
                logprob_sum=float(lp[r]), n_gen=int(ng[r]),
                finish_reason="beam", admitted_step=first.admitted_step,
                first_decode_step=first.first_decode_step,
                finished_step=self.step_count))
        self.beam_results[req.req_id] = {
            "scores": [float(x) for x in final_scores],
            "chosen": int(np.argmax(final_scores)),
            "beam_steps": run.beam_step,
        }
        self.metrics.completed_samples += len(survivors)
        self.metrics.completed_requests += 1
        if tr is not None:
            tr.event("release", req.req_id, step=self.step_count,
                     rows=[int(r) for r in rows], reason="beam")
            self.metrics.latencies.append(tr.request_latency(req.req_id))
        for r in rows:
            self.slots[r] = None
        del self._beams[req.req_id]

    # -- speculative rounds --------------------------------------------------
    def _spec_eligible(self, slot: _Slot) -> bool:
        """Rows a round may commit more than one token for: plain and
        Best-of-N rows that did not opt out.  Beam lanes stay one token
        per round (their freeze and boundary bookkeeping is stepwise)."""
        return slot.req.search is None and not slot.req.no_spec

    def _sync_draft_admissions(self, live: list) -> None:
        """Prefill newly admitted eligible rows' prompts into the dense
        drafter (draft-model mode), so its KV shadows the target's
        committed context from the prompt on."""
        rows = [i for i in live
                if self.slots[i].first_decode_step < 0
                and self._spec_eligible(self.slots[i])]
        if not rows:
            return
        padded = [self._pad(self.slots[i].req.prompt) for i in rows]
        st = self._draft.prefill(
            torch.stack([t for t, _ in padded]),
            torch.tensor([n for _, n in padded], dtype=torch.int32))
        self._draft_state = self._draft.merge_rows(self._draft_state, st,
                                                   rows)

    def _draft_proposals_self(self, xs, n_prop, eligible, W, generator,
                              sc) -> bool:
        """Self-drafting: W - 1 plain greedy steps on a refcounted
        snapshot of the target state (its divergent writes copy-on-write,
        its release frees; the target's KV is untouched).  Fills
        ``xs[:, 1:]`` in place; returns False when the snapshot ran out
        of blocks mid-draft (the round falls back to a plain step)."""
        eng = self.engine
        snap = eng.spec_snapshot(self.state, eligible)
        try:
            dts = []
            for m in range(1, W):
                frz = [i for i in eligible if int(n_prop[i]) == m]
                if frz:
                    snap = eng.freeze_rows(snap, frz)
                snap, dt = eng.step(snap, generator, sc,
                                    stop_ids=self.stop_ids, trace_core=False)
                dts.append(dt)
            # each row's last proposal comes from its (possibly frozen)
            # pending logits: the distribution after its last draft token
            final_h = torch.argmax(snap.pending_logits, dim=-1).cpu().numpy()
            dts_h = torch.stack(dts).cpu().numpy()
        except OutOfBlocks:
            eng.release_rows(snap, eligible)
            return False
        eng.release_rows(snap, eligible)
        for i in eligible:
            npi = int(n_prop[i])
            for c in range(1, npi - 1):
                xs[i, c] = int(dts_h[c][i])  # step c + 1 sampled column c
            xs[i, npi - 1] = int(final_h[i])
        return True

    def _draft_proposals_model(self, xs, n_prop, eligible, W, t0, clen_h,
                               generator, sc) -> GenState:
        """Draft-model proposals: resync the dense drafter's lengths to
        the target's committed context, force-feed the round's first
        token, then W - 1 greedy steps, each writing its proposal's KV so
        a fully accepted round leaves no hole.  Returns the advanced
        draft state (the caller rolls it back to the acceptance point
        only after the verify succeeds)."""
        de = self._draft
        dn = np.ones(self.n_slots, bool)
        dn[eligible] = False
        ds = dataclasses.replace(
            self._draft_state,
            cache_len=torch.as_tensor(clen_h, dtype=torch.int32,
                                      device=de.device),
            done=torch.as_tensor(dn, device=de.device))
        ds = de.forced_step(ds, t0)
        dts = []
        for m in range(1, W):
            frz = [i for i in eligible if int(n_prop[i]) == m]
            if frz:
                ds = de.freeze_rows(ds, frz)
            ds, dt = de.step(ds, generator, sc, stop_ids=self.stop_ids)
            dts.append(dt)
        dts_h = torch.stack(dts).cpu().numpy()
        for i in eligible:
            for c in range(1, int(n_prop[i])):
                xs[i, c] = int(dts_h[c - 1][i])  # step c sampled column c
        return ds

    def _spec_step(self, generator, sc: SamplerConfig):
        """One draft-then-verify round over the live batch.  Returns
        ``(xs, a)``, the proposals and each row's committed count, or None
        to fall back to a plain step (no row can use a second proposal,
        or the self-draft ran out of blocks).  An :class:`OutOfBlocks`
        from the verify's plan propagates to ``step_once``'s preemption
        loop and the round reruns; any snapshot was already released."""
        eng = self.engine
        live = [i for i, s in enumerate(self.slots) if s is not None]
        done_h = self.state.done.cpu().numpy()
        clen_h = self.state.cache_len.cpu().numpy()
        n_prop = np.zeros(self.n_slots, np.int32)
        for i in live:
            if done_h[i]:
                continue  # frozen beam lane: rides along, commits nothing
            slot = self.slots[i]
            if not self._spec_eligible(slot):
                n_prop[i] = 1  # a plain step's token inside the verify
            else:
                rem = slot.req.max_new_tokens - len(slot.tokens)
                n_prop[i] = max(1, min(self.spec.k, rem))
        W = int(n_prop.max(initial=0))
        if W < 2:
            return None
        eligible = [i for i in live if n_prop[i] > 1]
        # column 0: the token a plain greedy step would commit now
        t0 = torch.argmax(self.state.pending_logits, dim=-1).to(torch.int32)
        t0_h = t0.cpu().numpy()
        xs = np.full((self.n_slots, W), eng.pad_id, np.int32)
        for i in live:
            if n_prop[i]:
                xs[i, 0] = t0_h[i]
        ds = None
        if self.spec.self_draft:
            if not self._draft_proposals_self(xs, n_prop, eligible, W,
                                              generator, sc):
                return None
        else:
            ds = self._draft_proposals_model(xs, n_prop, eligible, W, t0,
                                             clen_h, generator, sc)
        self.state, commit = eng.spec_verify(
            self.state, xs, n_prop, row_stops=self._row_stops(),
            stop_ids=self.stop_ids)
        a = commit.sum(axis=1).astype(np.int64)
        # reclaim the rejected suffixes' blocks (rows live at verify time
        # only: frozen lanes keep their blocks like any frozen row)
        self.state = eng.trim_rows(self.state,
                                   [i for i in live if not done_h[i]])
        if ds is not None:
            # roll the drafter back to the acceptance point, every row
            # idle until the next round resyncs; only now that the verify
            # succeeded (a verify OutOfBlocks keeps the old draft state)
            self._draft_state = dataclasses.replace(
                ds, cache_len=torch.as_tensor(clen_h + a, dtype=torch.int32,
                                              device=ds.done.device),
                done=torch.ones_like(ds.done))
        m = self.metrics
        m.spec_rounds += 1
        for i in eligible:
            m.spec_draft_tokens += int(n_prop[i]) - 1
            m.spec_accepted_tokens += int(a[i]) - 1
            m.spec_committed_tokens += int(a[i])
            m.spec_row_steps += 1
        if self.tracer is not None:
            self.tracer.gauge("spec_accepted_tokens",
                              int(a[np.asarray(eligible, np.int64)].sum())
                              if eligible else 0)
        return xs, a

    # -- the step loop -------------------------------------------------------
    def _record_canary(self, live: list) -> None:
        """Drift comparison of a canary step: the production step's new
        logits against the engine's exact-path logits, over the live rows
        (frozen and done rows carry the same frozen pending logits in both
        paths, so every live row compares)."""
        prof = self.profiler
        exact = self.engine.last_canary_logits
        self.engine.last_canary_logits = None
        rows = torch.as_tensor(live, dtype=torch.long, device=exact.device)
        ex, pr = exact[rows], self.state.pending_logits[rows]
        max_err = float((ex - pr).abs().max()) if live else 0.0
        flips = (int((ex.argmax(-1) != pr.argmax(-1)).sum())
                 if live else 0)
        prof.record_canary(
            max_logit_err=max_err, flips=flips, rows=len(live),
            kv_err_per_layer=self.engine.kv_roundtrip_error())
        if self.tracer is not None:
            self.tracer.gauge("canary_max_logit_err", max_err)
            self.tracer.gauge("canary_flips", flips)

    def step_once(self, generator: Optional[torch.Generator],
                  sc: SamplerConfig = SamplerConfig()) -> bool:
        """One scheduler step (admit → decode → release).  Returns False
        when idle.  The step's host wall time, which ends with the copy of
        the sampled tokens to the host, lands in ``StepRecord.wall_s``.
        Under ``spec`` and greedy sampling the decode is a speculative
        round (see :class:`ContinuousScheduler`)."""
        tr = self.tracer
        prof = self.profiler
        if tr is not None:
            # the tracer's clock is the step wall's
            t_wall = t_step = tr.anchor()
        else:
            t_wall = self._clock()
        if prof is not None:
            prof.begin_step()
        admitted, prefill_tokens = self._admit()
        if tr is not None:
            tr.span("admit", t_step, step=self.step_count,
                    admitted=admitted, prefill_tokens=prefill_tokens)
        live = [i for i, s in enumerate(self.slots) if s is not None]
        if not live:
            return False
        if self._draft is not None:
            self._sync_draft_admissions(live)
        for i in live:
            if self.slots[i].first_decode_step < 0:
                self.slots[i].first_decode_step = self.step_count
        # the canary's exact replica is a paged-attention one: paged only
        canary = prof is not None and self.paged and prof.want_canary()
        # acceptance compares argmaxes: speculate under greedy only; a
        # canary step's exact replica is defined over the plain step
        spec_round = self.spec is not None and sc.greedy and not canary
        spec_out = None
        while True:
            try:
                if tr is not None:
                    t_dec = tr.now()
                if spec_round:
                    spec_out = self._spec_step(generator, sc)
                if spec_out is None:
                    self.state, toks = self.engine.step(
                        self.state, generator, sc, stop_ids=self.stop_ids,
                        row_stops=self._row_stops(), canary=canary,
                        graph=True)
                break
            except OutOfBlocks:
                # atomic: the failed plan touched neither pool nor state
                self._preempt_youngest()
                live = [i for i, s in enumerate(self.slots) if s is not None]
        if canary and self.engine.last_canary_logits is not None:
            self._record_canary(live)
        if tr is not None:
            t_rb = tr.now()
        if spec_out is not None:
            xs_h, a_h = spec_out
            toks_h = xs_h[:, 0]  # beam tracking sees the stepwise token
        else:
            a_h = None
            toks_h = toks.cpu().numpy()
        done_h, lp_h, ng_h = (
            t.cpu().numpy() for t in (self.state.done,
                                      self.state.logprob_sum,
                                      self.state.n_gen))
        if tr is not None:
            t_end = None
            if spec_out is None:
                # the host waits here for the card's rest of the step
                t_end = tr.span("readback", t_rb, step=self.step_count).t1
                tr.resolve_device()
            # closes after the copies to the host above (a device sync),
            # so the span is this decode step's host-visible latency
            tr.span("decode", t_dec, step=self.step_count, t1=t_end,
                    batch=len(live))
            seen: set = set()
            for i in live:
                rid = self.slots[i].req.req_id
                if (self.slots[i].first_decode_step == self.step_count
                        and rid not in self._ft_emitted):
                    self._ft_emitted.add(rid)
                    tr.event("first_token", rid, step=self.step_count)
                # every live non-beam row sampled a token this step (stop
                # tokens included); beam lanes are tracked in _beam_track
                if self.slots[i].req.search is None and rid not in seen:
                    seen.add(rid)
                    tr.event("token", rid, step=self.step_count)
        released = []
        for i in live:
            slot = self.slots[i]
            if slot.req.search is not None:
                continue  # beam lanes: tracked per tree below
            # the tokens this row committed: the accepted prefix of its
            # proposals in a speculative round, else the one sampled token
            run = ([int(t) for t in xs_h[i, :int(a_h[i])]]
                   if a_h is not None else [int(toks_h[i])])
            if bool(done_h[i]):          # committed a stop id (excluded)
                slot.tokens.extend(run[:-1])
                self._release(i, "stop", float(lp_h[i]), int(ng_h[i]))
                released.append((i, slot.req))
                continue
            slot.tokens.extend(run)
            if len(slot.tokens) >= slot.req.max_new_tokens:
                self._release(i, "length", float(lp_h[i]), int(ng_h[i]))
                released.append((i, slot.req))
        if released and self.cache is not None:
            # re-insert completed prompts before their blocks go back to
            # the pool: an LRU touch, or a restore of entries that pool
            # pressure evicted mid-flight (full prompt blocks still hold
            # valid prompt KV: they sit below the write frontier)
            seen: set = set()
            for r, req in released:
                if req.req_id not in seen:  # one insert per group
                    seen.add(req.req_id)
                    self._insert_prompt(self._host_prompt(req),
                                        self.state.table[r])
        if released:
            self.state = self.engine.release_rows(
                self.state, [r for r, _ in released])
        if self._beams:
            to_freeze, boundaries = self._beam_track(toks_h, done_h)
            if to_freeze:
                self.state = self.engine.freeze_rows(self.state, to_freeze)
                if tr is not None:
                    by_req: dict = {}
                    for r in to_freeze:
                        by_req.setdefault(self.slots[r].req.req_id,
                                          []).append(int(r))
                    for rid, rs in by_req.items():
                        tr.event("freeze", rid, step=self.step_count,
                                 rows=rs)
            for run in boundaries:
                self._beam_boundary(run)
        pool = self.engine.pool
        if self.paged:
            self.metrics.peak_kv_bytes = max(
                self.metrics.peak_kv_bytes,
                pool.peak_in_use * self._block_bytes)
        if tr is not None:
            tr.gauge("occupancy", len(live))
        if tr is not None and self.paged:
            tr.gauge("free_blocks", pool.free_blocks)
            # the storage the pool backs vs the bytes its live blocks
            # hold: memory pressure beside occupancy on one timeline
            tr.gauge("pool_reserved_bytes", pool.n_blocks * self._block_bytes)
            tr.gauge("kv_bytes_in_use", pool.blocks_in_use * self._block_bytes)
            if self.cache is not None:
                tr.gauge("cache_pinned_blocks", self.cache.n_cached_blocks)
        wall = self._clock() - t_wall
        if prof is not None:
            prof.end_step(wall)
            if tr is not None:
                # attributed kernel cost as counter tracks, so host spans
                # and kernel time line up on one timeline
                for k, v in prof.last_step_gauges.items():
                    tr.gauge(k, v)
        self.metrics.wall_s += wall
        self.metrics.record(StepRecord(
            step=self.step_count, occupancy=len(live), admitted=admitted,
            prefill_tokens=prefill_tokens, wall_s=wall,
            decode_tokens=(int(a_h[np.asarray(live, np.int64)].sum())
                           if a_h is not None else None)))
        if tr is not None:
            tr.span("step", t_step, step=self.step_count,
                    occupancy=len(live))
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
