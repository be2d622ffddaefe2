"""Paged KV-cache block pool with copy-on-write prefix sharing.

* Device storage is one pool per engine: ``k``/``v`` of shape
  ``(L, n_blocks, block_size, Hkv, D)`` (or {"codes", "scales"} dicts for
  the quantized pool, :class:`~repro_torch.serving.kv_quant.QuantKVPool`).
* Each sequence row holds a block table (position-ordered block ids), so
  block ``w`` of a row stores positions ``[w·bs, (w+1)·bs)``.
* Blocks are refcounted: ``fork`` bumps the refcount of every prompt
  block (zero KV copies) and the first divergent write to a shared block
  triggers copy-on-write (allocate + one-block device copy).
* Block 0 is the reserved scratch block: table padding points at it and
  done rows route their discarded decode writes there.

Accounting (free list, refcounts, peak usage) is host-side numpy.  The
device storage is updated **in place**: prefill and decode scatter into
the pool tensors and CoW copies blocks within them, so there is no
functional-update handshake with the engine.  Paged states reference
pool blocks by id and must be used linearly.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

SCRATCH_BLOCK = 0


class OutOfBlocks(RuntimeError):
    """The free list cannot satisfy an allocation.

    Carries ``needed``/``free`` so the scheduler can turn exhaustion into a
    preemption decision instead of a crash.
    """

    def __init__(self, needed: int, free: int):
        super().__init__(f"KV pool exhausted: need {needed} blocks, "
                         f"{free} free")
        self.needed = needed
        self.free = free


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` positions."""
    return -(-int(n_tokens) // block_size)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


class KVPool:
    """Refcounted block pool backing every paged sequence of one engine."""

    mode = "none"  # KV storage quantization (QuantKVPool overrides)

    def __init__(self, cfg: ModelConfig, n_blocks: int, block_size: int,
                 dtype: Optional[torch.dtype] = None, *, device):
        if n_blocks < 2:
            raise ValueError("KVPool needs >= 2 blocks (block 0 is the "
                             "reserved scratch block)")
        self.cfg = cfg
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.device = torch.device(device)
        storage = self._init_storage(cfg, n_blocks, block_size, dtype)
        self.k = storage["k"]
        self.v = storage["v"]
        self.refcount = np.zeros((n_blocks,), np.int32)
        # block 0 is never handed out: scratch for done-row writes + padding
        self._free: list[int] = list(range(n_blocks - 1, 0, -1))
        self.peak_in_use = 0
        self.cow_copies = 0

    def _init_storage(self, cfg: ModelConfig, n_blocks: int,
                      block_size: int, dtype) -> dict:
        from repro_torch.models.transformer import init_paged_cache

        return init_paged_cache(cfg, n_blocks, block_size, dtype,
                                device=self.device)

    # -- accounting ----------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        return self.n_blocks - 1 - len(self._free)

    @property
    def capacity(self) -> int:
        """Allocatable blocks (total minus the scratch block)."""
        return self.n_blocks - 1

    def block_bytes(self) -> int:
        """Device bytes of one block across all layers (K + V), measured on
        the storage tensors, so quantized blocks report their true size."""
        total = sum(t.numel() * t.element_size()
                    for t in _leaves({"k": self.k, "v": self.v}))
        return total // self.n_blocks

    def reset_peak(self):
        """Start a fresh peak-tracking interval; returns the ``cow_copies``
        watermark to subtract from the interval's end value."""
        self.peak_in_use = self.blocks_in_use
        return self.cow_copies

    def stats(self) -> dict:
        bb = self.block_bytes()
        return {
            "n_blocks": self.n_blocks,
            "block_size": self.block_size,
            "kv_quant": self.mode,
            "blocks_in_use": self.blocks_in_use,
            "peak_blocks_in_use": self.peak_in_use,
            "free_blocks": self.free_blocks,
            "cow_copies": self.cow_copies,
            "block_bytes": bb,
            "bytes_in_use": self.blocks_in_use * bb,
            "peak_bytes_in_use": self.peak_in_use * bb,
            "pool_reserved_bytes": self.n_blocks * bb,
        }

    # -- alloc / free / share ------------------------------------------------
    def reserve(self, n: int) -> bool:
        """Whether the free list covers ``n`` blocks.  A successful reserve
        promises that an immediately following :meth:`alloc`/:meth:`cow`
        of ``n`` blocks cannot fail (single-threaded host discipline)."""
        return n <= len(self._free)

    def alloc(self, n: int = 1) -> list[int]:
        """Take ``n`` blocks off the free list (refcount 1 each)."""
        if n > len(self._free):
            raise OutOfBlocks(n, len(self._free))
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self.refcount[b] = 1
        self.peak_in_use = max(self.peak_in_use, self.blocks_in_use)
        return out

    def retain(self, blocks, times: int = 1):
        """Bump refcounts (fork: prompt blocks gain one owner per sample)."""
        for b in np.asarray(blocks, np.int64).ravel():
            b = int(b)
            if b == SCRATCH_BLOCK:
                continue
            if self.refcount[b] <= 0:
                raise ValueError(f"retain of unallocated block {b}")
            self.refcount[b] += times

    def release(self, blocks):
        """Drop one reference per block; blocks at refcount 0 return to the
        free list."""
        for b in np.asarray(blocks, np.int64).ravel():
            b = int(b)
            if b == SCRATCH_BLOCK:
                continue
            if self.refcount[b] <= 0:
                raise ValueError(f"release of unallocated block {b}")
            self.refcount[b] -= 1
            if self.refcount[b] == 0:
                self._free.append(b)

    def cow(self, blocks) -> list[int]:
        """Copy-on-write: give each (shared) block a private copy.

        Allocates one fresh block per input, copies every storage leaf's
        block contents in place on the device, and drops one reference on
        each source.  Raises :class:`OutOfBlocks` before any mutation if
        the free list cannot cover the request.
        """
        blocks = [int(b) for b in blocks]
        if not blocks:
            return []
        if len(blocks) > len(self._free):
            raise OutOfBlocks(len(blocks), len(self._free))
        new = self.alloc(len(blocks))
        src = torch.tensor(blocks, dtype=torch.long, device=self.device)
        dst = torch.tensor(new, dtype=torch.long, device=self.device)
        for leaf in _leaves({"k": self.k, "v": self.v}):
            leaf[:, dst] = leaf[:, src]
        self.release(blocks)
        self.cow_copies += len(blocks)
        return new


def dense_kv_bytes(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=None) -> int:
    """What a dense engine would reserve for ``batch`` slots (comparison
    baseline for the paged pool's accounting)."""
    dtype = dtype or getattr(torch, cfg.dtype)
    per = cfg.n_layers * max_len * cfg.n_kv_heads * cfg.resolved_head_dim()
    return 2 * batch * per * torch.empty((), dtype=dtype).element_size()
