"""The one traffic generator: closed-loop Best-of-N tasks.

A mix file gives ``clients`` (tasks kept in flight), ``n_samples`` (N),
lognormal ``prompt`` and ``output`` lengths (``median``, ``sigma``,
``min``, ``max``), an optional ``header_tokens`` prefix shared by every
prompt, ``temperature`` and ``prefix_cache``.

Every seed sends the same sizes; the seed only draws the token ids.
Client c sends the sizes of its chain, one task after another: block b
of the chains holds the ``clients`` stratified quantiles of the prompt
and of the output distribution, each list shuffled once, the same for
every seed.  A closed loop's schedule follows from the chains alone, so
two seeds do the same work, step by step, on other tokens.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np

# ids below this are the tokenizer's pad, bos and eos
FIRST_ID = 3
# the name a mix file gives this generator
GENERATOR = "closed_best_of_n"


@dataclass
class Task:
    index: int
    prompt: np.ndarray       # (P,) int32 token ids, header included
    out_len: int             # max_new_tokens of every sample
    header: int              # tokens of the shared header at its start
    client: int


def quantiles(dist: dict, n: int) -> list:
    """The ``n`` stratified quantiles of a clipped lognormal, as whole
    tokens."""
    nd = NormalDist()
    out = []
    for i in range(n):
        z = nd.inv_cdf((i + 0.5) / n)
        x = dist["median"] * math.exp(dist["sigma"] * z)
        out.append(int(min(dist["max"], max(dist["min"], round(x)))))
    return out


def cached_tokens(task: Task, mix: dict) -> int:
    """The prompt tokens a prefix cache serves: the shared header, once
    the first task has put it there."""
    return task.header if mix.get("prefix_cache") and task.index else 0


def prompt_len(mix: dict) -> int:
    """The longest prompt the mix sends, header included."""
    return int(mix.get("header_tokens", 0)) + int(mix["prompt"]["max"])


def max_len(mix: dict, block_size: int) -> int:
    """The engine's max_len: the longest prompt plus the longest output
    plus the scratch slot, rounded up to a block."""
    need = prompt_len(mix) + int(mix["output"]["max"]) + 1
    return -(-need // block_size) * block_size


# the chains' shuffle: fixed, so that no seed changes the work
CHAIN_SEED = 0


class TaskStream:
    """The seed's repeatable tasks, one endless chain per client."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        if mix["generator"] != GENERATOR:
            raise ValueError(f"unknown traffic generator "
                             f"{mix['generator']!r}; this one is "
                             f"{GENERATOR!r}")
        self.vocab = vocab
        self.clients = int(mix["clients"])
        self.seed = int(seed)
        self.header = np.random.default_rng([self.seed, 0]).integers(
            FIRST_ID, vocab, size=int(mix.get("header_tokens", 0)),
            dtype=np.int64).astype(np.int32)
        self._p = quantiles(mix["prompt"], self.clients)
        self._o = quantiles(mix["output"], self.clients)
        self._blocks: list = []
        self._shuffle = np.random.default_rng(CHAIN_SEED)
        self.sent = [0] * self.clients
        self.n = 0

    def _block(self, b: int) -> list:
        while len(self._blocks) <= b:
            ps = self._shuffle.permutation(self._p)
            os_ = self._shuffle.permutation(self._o)
            self._blocks.append(list(zip(ps.tolist(), os_.tolist())))
        return self._blocks[b]

    def next(self, client: int) -> Task:
        """Client ``client``'s next task."""
        k = self.sent[client]
        self.sent[client] += 1
        p, o = self._block(k)[client]
        rng = np.random.default_rng([self.seed, 1, client, k])
        q = rng.integers(FIRST_ID, self.vocab, size=p,
                         dtype=np.int64).astype(np.int32)
        task = Task(index=self.n, prompt=np.concatenate([self.header, q]),
                    out_len=o, header=len(self.header), client=client)
        self.n += 1
        return task
