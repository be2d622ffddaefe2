"""The paged decode forward replayed from one CUDA graph.

A decode step of a paged transformer is ~11k small launches; dispatched
op by op from Python, the card waits on the host between them.  Every
shape of the step is fixed by the scheduler's slot state: ``n_slots``
rows (done rows write to the scratch position), a table of
``max_len // block_size`` columns, K2's split count from (B, Hkv, W) and
K3's plan from (M, K, N).  So one graph, captured once, serves every
step of a run.

:class:`DecodeGraph` holds the static inputs (tokens, model lengths,
the block table), the captured forward and its output logits.  The
kernels inside are the same hand-written launches with the same plans;
only the host's per-op dispatch goes.  The pool leaves and the params are
read in place, so a replay checks that the pool's leaves still sit where
they were captured (:meth:`DecodeGraph.matches`).

The wrappers count their launches when Python calls them, which a
replay does not: the capture records the counters' difference and takes
it back, and each replay adds it, so the launch counters read as an
eager step's.

The engine decides when to replay (``DecodeEngine._graph_for``); this
module only captures and replays.  ``_record`` and ``_replay`` are the
two CUDA calls, which a test stands in for on the CPU.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def pool_pointers(pool) -> tuple:
    """The data pointers of a pool's K and V leaves (tensors, or the
    quantized pools' {"codes", "scales"} dicts)."""
    out = []
    for leaf in (pool.k, pool.v):
        parts = leaf.values() if isinstance(leaf, dict) else (leaf,)
        out.extend(t.data_ptr() for t in parts)
    return tuple(out)


class DecodeGraph:
    """One decode forward at batch ``batch`` and table width ``width``,
    captured once and replayed."""

    def __init__(self, *, batch: int, width: int, device, impl: str,
                 pointers: tuple):
        self.batch = batch
        self.impl = impl
        self.pointers = pointers
        self.tok = torch.zeros((batch,), dtype=torch.int32, device=device)
        self.model_len = torch.ones((batch,), dtype=torch.int32,
                                    device=device)
        self.table = torch.zeros((batch, width), dtype=torch.int32,
                                 device=device)
        self.out = None          # the captured forward's logits
        self.launches: dict = {}  # launch counters a replay adds
        self.replays = 0
        self._graph = None

    @staticmethod
    def available(device) -> bool:
        """Whether a graph can be captured on ``device``."""
        return torch.device(device).type == "cuda"

    def matches(self, batch: int, impl, pointers: tuple) -> bool:
        """Whether a step of ``batch`` rows under the paged-attention
        ``impl`` over a pool at ``pointers`` is the captured one."""
        return (batch == self.batch and impl == self.impl
                and pointers == self.pointers)

    def capture(self, forward: Callable) -> None:
        """Capture ``forward(tok, table, model_len)``, the model's decode
        step over the engine's pool ((B,) int32 tokens, the (B, W) int32
        table, (B,) int32 lengths after the token -> (B, V) f32 logits),
        over the static inputs.  Nothing runs on the card until the first
        :meth:`run`, and the graph keeps no reference to ``forward``."""
        from repro_torch.kernels import ops

        before = ops.launch_tally()
        self.out = self._record(
            lambda: forward(self.tok, self.table, self.model_len))
        self.launches = ops.tally_delta(before, ops.launch_tally())
        ops.add_launches(self.launches, times=-1)

    def run(self, tok: torch.Tensor, model_len: torch.Tensor,
            table: np.ndarray) -> torch.Tensor:
        """One step: copy the inputs in, replay, count the launches.
        Returns the graph's logits buffer, which the next replay
        overwrites: read it before then."""
        from repro_torch.kernels import ops

        self.tok.copy_(tok)
        self.model_len.copy_(model_len)
        # CUDA stages a pageable host buffer at the call, so the host
        # neither waits for the card nor must keep the array
        self.table.copy_(torch.from_numpy(table), non_blocking=True)
        self._replay()
        ops.add_launches(self.launches)
        self.replays += 1
        return self.out

    # -- the two CUDA calls ------------------------------------------------
    def _record(self, fn: Callable) -> torch.Tensor:
        """Capture ``fn`` into a graph on a side stream (a capture may not
        use the legacy default stream) and instantiate it.  The capture
        neither collects garbage nor empties the allocator's cache (as
        ``torch.cuda.graph`` does): set-up pays for the forward's dispatch
        and the instantiation alone."""
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream(device=main.device)
        side.wait_stream(main)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            graph.capture_begin()
            try:
                out = fn()
            finally:
                graph.capture_end()
        main.wait_stream(side)
        self._graph = graph
        return out

    def _replay(self) -> None:
        self._graph.replay()
