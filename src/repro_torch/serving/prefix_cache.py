"""Cross-request prefix cache: a radix tree over the KV block pool.

Copy-on-write sharing covers forks within one request (Best-of-N samples
sharing one prompt's blocks).  Test-time-scaling traffic also repeats the
same system prompt and few-shot header across requests, and prefill is
the phase worth skipping on a fixed hardware budget.  This module keeps
completed prompt prefixes alive in the pool after their requests finish,
so the next request that shares a prefix skips re-prefilling it:

* the tree is keyed on **token-id chunks at block granularity**: one node
  per KV block, children keyed by the ``block_size``-token chunk that
  produced the block, so a root-to-node path spells out an exact token
  prefix whose KV lives in the nodes' pool blocks;
* every node **owns one reference** to its block in the shared
  :class:`~repro_torch.serving.kv_pool.KVPool`, so fork/CoW/release
  semantics compose unchanged (a cached block used by a live row has
  refcount >= 2 and is never written: full prompt blocks sit below every
  row's write frontier);
* :meth:`match` walks the longest cached prefix of a prompt and *leases*
  the matched blocks to the caller (refcount +1 per block, transferred to
  the admitted row), so eviction between match and prefill cannot free
  them.  A trailing partial-chunk match reuses a cached block's first
  ``r`` positions; the engine copy-on-writes that tail block before
  overwriting its remainder;
* :meth:`insert` records a finished prefill's full prompt blocks (partial
  trailing blocks are never cached: decode writes would clobber them).
  Inserting an already-cached prefix is an idempotent LRU touch;
* :meth:`evict` frees least-recently-used **unreferenced leaves** and is
  registered as the pool's ``pressure_hook``, so allocation pressure
  reclaims cache space before the scheduler preempts;
* :meth:`probe` (a stats- and lease-free lookup), :meth:`potential_match`
  and :meth:`insert_batch` support the scheduler's batched cache-aware
  admission.

Accounting is host-side and single-threaded; KV bytes never move on
insert/match/evict, only refcounts do.  The same tree as the JAX
package's ``PrefixCache``, operation for operation.
"""
from __future__ import annotations

import heapq
import warnings
from typing import Iterable, Optional

from repro_torch.serving.kv_pool import KVPool


class _Node:
    """One cached KV block: ``chunk`` (block_size token ids) -> ``block``."""

    __slots__ = ("chunk", "block", "parent", "children", "last_used")

    def __init__(self, chunk: Optional[tuple], block: int,
                 parent: Optional["_Node"]):
        self.chunk = chunk
        self.block = block
        self.parent = parent
        self.children: dict[tuple, "_Node"] = {}
        self.last_used = 0


class PrefixCache:
    """Radix tree of cached prompt prefixes over one engine's block pool.

    ``capacity_blocks`` caps how many pool blocks the cache may pin
    (admission control); ``None`` leaves it bounded only by pool pressure
    (the eviction hook).  Constructing the cache registers its
    :meth:`evict` as ``pool.pressure_hook``.
    """

    def __init__(self, pool: KVPool, *,
                 capacity_blocks: Optional[int] = None):
        if capacity_blocks is not None and capacity_blocks < 0:
            raise ValueError("capacity_blocks must be >= 0 or None")
        self.pool = pool
        self.block_size = pool.block_size
        self.capacity = capacity_blocks
        self.root = _Node(chunk=None, block=-1, parent=None)
        self._clock = 0
        self.n_cached_blocks = 0
        # lifetime counters (see stats())
        self.lookups = 0
        self.hits = 0
        self.tokens_matched = 0
        self.insertions = 0
        self.evictions = 0
        prev = getattr(pool.pressure_hook, "__self__", None)
        if pool.pressure_hook is not None and not (
                isinstance(prev, PrefixCache) and prev.n_cached_blocks == 0):
            # replacing a cache that still pins blocks strands them: they
            # can no longer be reclaimed under pool pressure
            warnings.warn(
                "replacing this KVPool's pressure hook while the previous "
                "prefix cache still pins blocks — clear() the old cache "
                "first so its blocks return to the free list",
                RuntimeWarning, stacklevel=2)
        pool.pressure_hook = self.evict

    # -- lookup --------------------------------------------------------------
    def _walk(self, toks: list, *, touch: bool) -> tuple[list[int], int]:
        """Longest-cached-prefix walk shared by :meth:`match` and
        :meth:`probe`: full-block chunk descent plus the partial
        trailing-chunk rule.  ``touch=True`` LRU-touches visited nodes."""
        bs = self.block_size
        node = self.root
        blocks: list[int] = []
        i = 0
        while i + bs <= len(toks):
            child = node.children.get(tuple(toks[i:i + bs]))
            if child is None:
                break
            if touch:
                child.last_used = self._clock
            blocks.append(child.block)
            node = child
            i += bs
        # partial trailing chunk: a cached block whose chunk agrees on the
        # remaining r tokens serves positions [i, i + r) verbatim
        r = len(toks) - i
        if 0 < r < bs:
            for child in node.children.values():
                if list(child.chunk[:r]) == toks[i:]:
                    if touch:
                        child.last_used = self._clock
                    blocks.append(child.block)
                    i += r
                    break
        return blocks, i

    def match(self, tokens) -> tuple[list[int], int]:
        """Longest-cached-prefix lookup.  Returns ``(blocks, cached_len)``.

        ``blocks`` covers positions ``[0, cached_len)`` in table order and
        arrives with **one extra reference per block owned by the caller**
        (the lease the admitted row will hold; release it if admission is
        abandoned).  ``cached_len`` is a multiple of ``block_size`` except
        when a trailing partial-chunk match reuses the first ``cached_len
        % block_size`` positions of a cached block — the engine's partial
        prefill copy-on-writes that tail before extending it.  Callers cap
        the searched prefix themselves (typically ``prompt[:-1]`` so at
        least one token is recomputed for the next-token logits).

        Counts toward :meth:`stats` (one lookup; a hit when any block
        matched) and LRU-touches the matched path.  Use :meth:`probe` for
        planning passes that must not take a lease or skew the stats.
        """
        toks = [int(t) for t in tokens]
        self._clock += 1
        self.lookups += 1
        blocks, i = self._walk(toks, touch=True)
        if blocks:
            self.pool.retain(blocks)  # the caller's lease
            self.hits += 1
            self.tokens_matched += i
        return blocks, i

    def probe(self, tokens) -> int:
        """Length of the longest cached prefix of ``tokens`` *without*
        taking a lease, LRU-touching nodes, or counting a lookup.

        The planning half of batched admission: the scheduler probes a
        candidate to decide whether to lease now (:meth:`match`) or defer
        it until an earlier request in the same batch has inserted a
        longer shared prefix.  Purely read-only on tree and pool."""
        blocks, i = self._walk([int(t) for t in tokens], touch=False)
        return i

    def potential_match(self, tokens, prompt) -> int:
        """Length :meth:`match`/:meth:`probe` of ``tokens`` would return
        against a tree holding only :meth:`insert` of ``prompt`` — no
        tree access, pure token arithmetic.

        This is batched admission's deferral estimate: a same-run earlier
        request with ``prompt`` has not prefilled yet, so its blocks
        cannot be leased, but once it inserts, the union-tree match is
        the max of :meth:`probe` and this over the run's prompts (radix
        chains only merge on identical chunks, so the longest prefix in
        the union is the max over individual chains).  Mirrors the match
        rules exactly: the full-block walk stops at the common prefix,
        at ``tokens``'s own last full block, and at the full blocks
        ``prompt`` actually inserts; the partial-trailing-chunk rule
        applies when the remaining ``r < block_size`` query tokens agree
        with the next inserted block.  Callers cap the searched prefix
        as they do for match (typically ``prompt[:-1]``)."""
        toks = [int(t) for t in tokens]
        other = [int(t) for t in prompt]
        bs = self.block_size
        cap = len(toks)
        limit = (len(other) // bs) * bs  # tokens the insert records
        raw = 0
        for a, b in zip(toks, other):
            if a != b:
                break
            raw += 1
        i = min((raw // bs) * bs, (cap // bs) * bs, limit)
        r = cap - i
        if 0 < r < bs and raw >= cap and i < limit:
            return cap                   # partial tail serves [i, cap)
        return i

    # -- insertion -----------------------------------------------------------
    def insert(self, tokens, blocks) -> int:
        """Record a prefilled prompt's blocks; returns blocks newly pinned.

        ``tokens`` is the full prompt; ``blocks[j]`` must hold positions
        ``[j*bs, (j+1)*bs)`` of it (a row's table prefix).  Only full
        blocks are inserted.  Existing nodes are LRU-touched, missing ones
        pinned with a fresh pool reference; insertion stops (rather than
        evicting its own path) when the capacity cap cannot be honored.
        """
        toks = [int(t) for t in tokens]
        bs = self.block_size
        self._clock += 1
        node = self.root
        added = 0
        path_ids = {id(self.root)}
        for j in range(len(toks) // bs):
            chunk = tuple(toks[j * bs:(j + 1) * bs])
            child = node.children.get(chunk)
            if child is None:
                if (self.capacity is not None
                        and self.n_cached_blocks >= self.capacity
                        and not self.evict(1, avoid=path_ids)):
                    break  # full and nothing evictable outside our path
                blk = int(blocks[j])
                self.pool.retain([blk])
                child = _Node(chunk=chunk, block=blk, parent=node)
                node.children[chunk] = child
                self.n_cached_blocks += 1
                self.insertions += 1
                added += 1
            child.last_used = self._clock
            node = child
            path_ids.add(id(child))
        return added

    def insert_batch(self, items) -> int:
        """Record a *batch* of prefilled prompts in one call.

        ``items`` iterates ``(tokens, blocks)`` pairs with the
        :meth:`insert` contract each.  This is the insert half of batched
        admission: after one batched partial prefill admits N rows, all N
        prompts land in the tree before the next admission round matches
        against it (order within the batch is preserved, so shared paths
        dedup exactly as sequential inserts would).  Returns the total
        number of blocks newly pinned."""
        return sum(self.insert(toks, blocks) for toks, blocks in items)

    # -- eviction ------------------------------------------------------------
    def _evictable_leaves(self, avoid) -> list[_Node]:
        out = []
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif id(n) not in avoid and self.pool.refcount[n.block] == 1:
                out.append(n)  # tree is the sole owner: freeing frees device memory
        return out

    def evict(self, n: int, avoid: Iterable[int] = ()) -> int:
        """Free up to ``n`` pool blocks by dropping LRU unreferenced
        leaves (refcount 1 = pinned by the tree alone; blocks leased to
        live rows are skipped — releasing them would reclaim nothing).
        One tree walk seeds a min-heap on ``last_used``; evicting a leaf
        pushes its parent when that becomes the next candidate.  Returns
        the number of blocks actually freed."""
        avoid = set(avoid)
        freed = 0
        heap = [(nd.last_used, id(nd), nd)
                for nd in self._evictable_leaves(avoid)]
        heapq.heapify(heap)
        while heap and freed < n:
            _, _, victim = heapq.heappop(heap)
            self.pool.release([victim.block])
            parent = victim.parent
            del parent.children[victim.chunk]
            self.n_cached_blocks -= 1
            self.evictions += 1
            freed += 1
            if (parent is not self.root and not parent.children
                    and id(parent) not in avoid
                    and self.pool.refcount[parent.block] == 1):
                heapq.heappush(heap, (parent.last_used, id(parent), parent))
        return freed

    def clear(self) -> int:
        """Drop every cached prefix (releases all pinned blocks)."""
        freed = 0
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            self.pool.release([n.block])
            freed += 1
        self.root.children.clear()
        self.n_cached_blocks = 0
        self.evictions += freed
        return freed

    # -- introspection -------------------------------------------------------
    def cached_block_ids(self) -> set[int]:
        """Pool block ids currently pinned by the tree (leak checks)."""
        out = set()
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            out.add(n.block)
        return out

    def stats(self) -> dict:
        return {
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_rate": self.hits / self.lookups if self.lookups else 0.0,
            "tokens_matched": self.tokens_matched,
            "cached_blocks": self.n_cached_blocks,
            "cached_tokens": self.n_cached_blocks * self.block_size,
            "cached_bytes": self.n_cached_blocks * self.pool.block_bytes(),
            "capacity_blocks": self.capacity,
            "insertions": self.insertions,
            "evictions": self.evictions,
        }
