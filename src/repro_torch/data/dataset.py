"""Training data pipeline: packing, host-sharded batching, async prefetch.

A copy of the JAX package's ``data/dataset.py`` (which imports no JAX):
given the same seed and arguments, the loaders yield byte-equal numpy
batches."""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from repro_torch.data.tasks import gen_dataset
from repro_torch.data.tokenizer import ByteTokenizer


def pack_documents(docs, tok: ByteTokenizer, seq_len: int,
                   *, loss_prompt: bool = False):
    """Pack (prompt, target) docs into (tokens, targets, loss_mask) rows.

    Documents are concatenated (each ``bos ... eos``) and split into rows of
    ``seq_len``+1; targets are the 1-shifted tokens; loss_mask optionally
    zeroes prompt positions so only completions are learned.
    """
    stream, mask = [], []
    for prompt, target in docs:
        p_ids = tok.encode(prompt, bos=True, eos=False)
        t_ids = tok.encode(target, bos=False, eos=True)
        stream.extend(p_ids + t_ids)
        mask.extend(([1] * len(p_ids) if loss_prompt else [0] * len(p_ids))
                    + [1] * len(t_ids))
    n_rows = max(1, (len(stream) - 1) // seq_len)
    rows_t, rows_y, rows_m = [], [], []
    for r in range(n_rows):
        a = r * seq_len
        chunk = stream[a: a + seq_len + 1]
        m = mask[a + 1: a + seq_len + 1]
        if len(chunk) < seq_len + 1:
            pad = seq_len + 1 - len(chunk)
            chunk = chunk + [tok.pad_id] * pad
            m = m + [0] * pad
        rows_t.append(chunk[:-1])
        rows_y.append(chunk[1:])
        rows_m.append(m[: seq_len])
    return (np.array(rows_t, np.int32), np.array(rows_y, np.int32),
            np.array(rows_m, np.float32))


class MathDataLoader:
    """Deterministic, host-shardable loader over synthetic math tasks.

    ``host_id``/``n_hosts`` split the stream so each host of a multi-pod job
    reads disjoint data (the seed folds the host id in).  ``prefetch`` keeps
    a background thread one batch ahead of the training loop.
    """

    def __init__(self, tok: ByteTokenizer, *, batch_size: int, seq_len: int,
                 seed: int = 0, host_id: int = 0, n_hosts: int = 1,
                 tasks_per_chunk: int = 512, reasoning: bool = True,
                 max_terms: int = 4, prefetch: int = 2):
        self.tok = tok
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.seed = seed * n_hosts + host_id
        self.reasoning = reasoning
        self.max_terms = max_terms
        self.tasks_per_chunk = tasks_per_chunk
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        chunk = 0
        buf_t = buf_y = buf_m = None
        while not self._stop.is_set():
            tasks = gen_dataset(self.seed + chunk * 7919, self.tasks_per_chunk,
                                reasoning=self.reasoning,
                                max_terms=self.max_terms)
            chunk += 1
            t, y, m = pack_documents(
                [(tk.prompt, tk.target) for tk in tasks], self.tok, self.seq_len)
            if buf_t is not None:
                t = np.concatenate([buf_t, t]); y = np.concatenate([buf_y, y])
                m = np.concatenate([buf_m, m])
            n_full = (len(t) // self.batch_size) * self.batch_size
            for i in range(0, n_full, self.batch_size):
                if self._stop.is_set():
                    return
                self._q.put((t[i:i + self.batch_size],
                             y[i:i + self.batch_size],
                             m[i:i + self.batch_size]))
            buf_t, buf_y, buf_m = t[n_full:], y[n_full:], m[n_full:]

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
