"""Fault tolerance: preemption handling, restart-from-checkpoint, straggler
detection.  Host-side only: the JAX package's module with its unused JAX
import dropped, and restore taking the port's template tree.

At 1000+ node scale the failure model is: (a) planned preemption (SIGTERM
with a grace period), (b) hard node loss (job reschedules, restarts from
the latest checkpoint), (c) stragglers (slow host degrades the whole
synchronous step).  This module provides the pieces launch/train.py wires
together:

* ``PreemptionHandler`` — SIGTERM/SIGINT triggers one emergency checkpoint
  before exit;
* ``resume_or_init`` — restart logic: restore the latest checkpoint if one
  exists, else fresh init (idempotent re-launch);
* ``StragglerMonitor`` — rolling step-time statistics; flags steps slower
  than ``threshold ×`` the rolling median and keeps a slow-host counter the
  launcher can act on (re-shard / evict in a real deployment; here: logged
  and surfaced in metrics).
"""
from __future__ import annotations

import collections
import signal
import statistics
from typing import Callable, Optional



class PreemptionHandler:
    """Install SIGTERM/SIGINT hooks that run an emergency checkpoint."""

    def __init__(self, save_fn: Callable[[], None]):
        self.save_fn = save_fn
        self.preempted = False
        self._orig = {}

    def __enter__(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            self._orig[sig] = signal.signal(sig, self._handler)
        return self

    def _handler(self, signum, frame):
        if not self.preempted:
            self.preempted = True
            try:
                self.save_fn()
            finally:
                pass

    def __exit__(self, *exc):
        for sig, orig in self._orig.items():
            signal.signal(sig, orig)
        return False


def resume_or_init(checkpointer, template, init_fn, log_fn=print, *,
                   device=None):
    """Restore the latest checkpoint or initialize fresh.

    ``template``: the tree to restore into (its structure, shapes and
    dtypes; ``meta`` tensors will do, restored onto ``device``).  Returns
    (tree, start_step). This is the restart path after any failure:
    relaunching the identical command continues from the last save.
    """
    step = checkpointer.latest_step()
    if step is not None:
        tree, step = checkpointer.restore(template, step=step,
                                          device=device)
        log_fn(f"[ft] restored checkpoint at step {step}")
        return tree, step
    log_fn("[ft] no checkpoint found — fresh init")
    return init_fn(), 0


class StragglerMonitor:
    def __init__(self, window: int = 50, threshold: float = 2.0,
                 log_fn=print):
        self.times = collections.deque(maxlen=window)
        self.threshold = threshold
        self.slow_steps = 0
        self.log_fn = log_fn

    def record_step(self, dt: float):
        if len(self.times) >= 5:
            med = statistics.median(self.times)
            if dt > self.threshold * med:
                self.slow_steps += 1
                self.log_fn(f"[straggler] step took {dt:.3f}s "
                            f"(median {med:.3f}s, x{dt / med:.1f})")
        self.times.append(dt)

    @property
    def median(self) -> Optional[float]:
        return statistics.median(self.times) if self.times else None

    def summary(self) -> dict:
        return {"median_step_s": self.median, "slow_steps": self.slow_steps,
                "window": len(self.times)}
