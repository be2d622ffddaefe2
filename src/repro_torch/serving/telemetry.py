"""Request-lifecycle tracing and tail-latency derivation for the serving
stack (the JAX package's ``serving/telemetry``, extended with spans
inside the decode step, stamps on the device trace's clock and the
sampler's device time).

Every stage of a request's life is observable without touching the hot
path when disabled:

* :class:`Tracer` — an append-only recorder of **typed, monotonic-clocked
  lifecycle events** (``enqueue -> admit[cache hit / lease width] ->
  first_token -> per-step token -> freeze/resume -> beam_boundary ->
  preempt/readmit -> release``), **phase spans** inside the scheduler and
  engine and **per-step gauges** (free pool blocks, prefix-cache pinned
  blocks, slot occupancy).  The spans nest as::

      step ⊃ {admit ⊃ prefill ⊃ gather,
              decode ⊃ {plan, sample, forward ⊃ capture, readback,
                        spec_verify},
              prm}

  ``admit`` is admission with its prefill calls; ``gather`` a cached
  prefill's read of the cached blocks (``_gather_prefix``, K4 on a
  quantized pool); ``plan`` the paged CoW/alloc host planning;
  ``sample`` the sampler (``sample`` + ``logprobs_of``) and the stop and
  length bookkeeping before the model call; ``forward`` the model's
  decode step (``graph=`` whether replayed from the engine's CUDA
  graph); ``capture`` that graph's one capture (``batch=``,
  ``width=``); ``readback`` the copies of the step's tokens, done flags,
  logprobs and counts to the host, where the host waits for the card;
  ``spec_verify`` a speculative round's verify forward; ``prm`` the PRM
  score callbacks.  ``sample``, ``forward`` and ``readback`` belong to a
  plain decode step: the canary's exact-path replica and a speculative
  round's self-draft steps record none.
* :meth:`Tracer.request_latency` — derives one
  :class:`RequestLatency` record per request from the event stream:
  queue wait (enqueue -> first admit), TTFT (enqueue -> first token),
  inter-token gaps, preemption-added delay (preempt -> readmit), and
  end-to-end time.  ``SchedulerMetrics`` aggregates these into
  ``ttft_p50/p90/p99``, ``itl_p50/p99``, ``queue_wait_p50/p99`` and
  ``step_time_p50/p99`` summary keys.
* :meth:`Tracer.to_chrome_trace` — exports a **Chrome trace-event JSON**
  loadable in Perfetto (https://ui.perfetto.dev): phase spans as nested
  slices on a ``phases`` track, each decode slot as its own track whose
  slices are the requests occupying it (lifecycle instants riding on
  top), and the gauges as counter tracks.  ``launch/serve.py --trace
  out.json`` writes one; ``python -m repro_torch.serving.telemetry
  out.json`` validates it (see :func:`validate_chrome_trace`).

**Clock semantics.**  Every timestamp is ``clock() - t0`` seconds where
``clock`` is injectable (default ``time.perf_counter`` — monotonic,
sub-microsecond).  Tests inject a deterministic counter so latency
derivations are exact; the scheduler uses the same clock for its per-step
``wall_s``, so ``step_time_*`` percentiles are deterministic under an
injected clock too.  Spans measure *host-side* time.  PyTorch runs
eagerly, so a span holds the host's dispatch of every op inside it; the
``readback`` span (and the ``decode`` span around it) closes after the
copies to the host (a device sync), while the prefill span closes when
its last op is queued (CUDA is asynchronous; the next sync absorbs the
device tail).

**The device trace's clock.**  Each span also carries ``u0`` / ``u1``,
its ends in seconds on the Unix clock (``unix_clock``, default
``time.time_ns``, injectable like ``clock``), the clock
``torch.profiler`` stamps device activity with.  They come from an
anchor pair (tracer time, Unix time), the tightest of
``ANCHOR_READS`` back-to-back reads, taken at construction and again by
:meth:`Tracer.anchor` when each ``step`` span opens, so drift between
the two clocks stays within one step.  A span thereby lines up with a
device trace by itself.

**Device time.**  On a CUDA engine the ``sample`` span's
``args["device_s"]`` is the card's time between two CUDA events recorded
on the current stream when the span opens and when it closes (idle gaps
on the stream between them included): the sampler's time on the card.
The events are read by :meth:`Tracer.resolve_device` once the step's
``readback`` has synchronised, so timing adds no synchronise of its own.
On the CPU there is no event and no ``device_s``.

**Zero overhead when disabled.**  The scheduler and engine hold
``tracer=None`` by default and guard every touchpoint with ``if tracer
is not None`` — no events, no allocations, bit-identical outputs.  No
``record_function`` or NVTX range is opened: with CUDA activity the
profiler could project them onto the device timeline as busy time.
"""
from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

# Event kinds the scheduler/engine emit, in (one possible) lifecycle
# order.  ``token`` is per request per decode step; the rest are
# transitions.  Exporters and tests should treat unknown kinds as valid
# (forward compatibility), but everything the stack emits today is here.
EVENT_KINDS = (
    "enqueue",        # Request.submit; args: —
    "admit",          # slots filled; args: rows, cache_hit, lease_tokens
    "readmit",        # admit of a previously preempted request
    "first_token",    # the request's first decode token this admission
    "token",          # >= 1 of the request's rows sampled a token
    "freeze",         # beam lanes parked at their step budget; args: rows
    "resume",         # frozen lanes re-armed after a boundary; args: rows
    "beam_boundary",  # one prune+expand commit; args: boundary
    "preempt",        # out-of-blocks victim; args: rows
    "release",        # rows freed; args: rows, reason
)

SPAN_NAMES = ("step", "admit", "prefill", "gather", "decode", "plan",
              "sample", "forward", "capture", "readback", "prm",
              "spec_verify")

# Unix clock reads per anchor, each between two reads of the tracer's
# clock; the one with the narrowest bracket wins
ANCHOR_READS = 3


@dataclass
class Event:
    """One lifecycle event: ``kind`` at monotonic time ``t`` (seconds
    since the tracer's epoch), attributed to ``req_id`` (-1 = none) at
    scheduler step ``step`` (-1 = outside the step loop)."""

    kind: str
    t: float
    req_id: int = -1
    step: int = -1
    args: dict = field(default_factory=dict)


@dataclass
class Span:
    """One completed phase span ``[t0, t1]`` on the scheduler's phase
    timeline (nesting in the module docstring); ``[u0, u1]`` is the same
    span in Unix seconds, the device trace's clock."""

    name: str
    t0: float
    t1: float
    step: int = -1
    args: dict = field(default_factory=dict)
    u0: float = 0.0
    u1: float = 0.0


@dataclass
class Gauge:
    """One sample of a per-step gauge (counter track in the export)."""

    name: str
    t: float
    value: float


@dataclass(frozen=True)
class RequestLatency:
    """Per-request latency record derived from the event stream.

    All values in seconds.  ``gaps`` are the inter-token intervals
    (diffs of consecutive ``token`` event times — across a preemption
    they include the requeue wait, which *is* the latency the client
    saw); ``preempt_delay`` is the total time spent requeued between
    ``preempt`` and the matching ``readmit``."""

    req_id: int
    queue_wait: float            # enqueue -> first admit
    ttft: float                  # enqueue -> first decode token
    gaps: tuple                  # inter-token intervals
    preempt_delay: float         # sum of preempt -> readmit waits
    e2e: float                   # enqueue -> last release


def percentile(xs, q: float) -> float:
    """Linear-interpolated percentile; 0.0 on empty input (so summary
    keys are safe on drains that admitted nothing)."""
    xs = [x for x in xs]
    if not xs:
        return 0.0
    return float(np.percentile(np.asarray(xs, np.float64), q))


def cuda_mark(device):
    """A timing event recorded now on ``device``'s current CUDA stream
    (the ends of a span's ``device_s``), or None off CUDA."""
    if device.type != "cuda":
        return None
    import torch

    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class Tracer:
    """Append-only recorder of events, phase spans and gauges.

    ``clock`` is any zero-arg callable returning monotonically
    non-decreasing floats (seconds).  All recorded times are relative to
    the clock's value at construction, so traces start at t=0.
    ``unix_clock`` returns integer nanoseconds since the Unix epoch (the
    device trace's clock); spans carry their ends on it as ``u0`` /
    ``u1``.
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 unix_clock: Callable[[], int] = time.time_ns):
        self.clock = clock
        self.unix_clock = unix_clock
        self._t0 = clock()
        self.events: list[Event] = []
        self.spans: list[Span] = []
        self.gauges: list[Gauge] = []
        self._by_req: dict[int, list[Event]] = {}
        # (span, start event, end event) whose device time is not read yet
        self._on_device: list[tuple] = []
        self.anchor()

    # -- recording -----------------------------------------------------------
    def now(self) -> float:
        """Seconds since the tracer's epoch (monotonic)."""
        return self.clock() - self._t0

    def anchor(self) -> float:
        """Re-take the (tracer time, Unix time) pair that places spans on
        the device trace's clock: ``ANCHOR_READS`` Unix reads, each
        between two reads of the tracer's clock, and of them the one
        whose two clock reads lie closest, at their midpoint.  Returns
        the last clock read as :meth:`now` (the scheduler opens each
        ``step`` span with it)."""
        a = self.clock()
        best = None
        for _ in range(ANCHOR_READS):
            u = self.unix_clock()
            b = self.clock()
            if best is None or b - a < best[0]:
                best = (b - a, (a + b) / 2 - self._t0, u / 1e9)
            a = b
        self._anchor = best[1:]
        return a - self._t0

    def unix(self, t: float) -> float:
        """Tracer time ``t`` in Unix seconds, by the latest anchor."""
        return self._anchor[1] + (t - self._anchor[0])

    def event(self, kind: str, req_id: int = -1, step: int = -1,
              **args) -> Event:
        ev = Event(kind=kind, t=self.now(), req_id=req_id, step=step,
                   args=args)
        self.events.append(ev)
        if req_id >= 0:
            self._by_req.setdefault(req_id, []).append(ev)
        return ev

    def span(self, name: str, t0: float, step: int = -1, *,
             t1: Optional[float] = None, **args) -> Span:
        """Record a completed span that started at ``t0`` (a prior
        :meth:`now` value) and ends at ``t1``, by default now."""
        t1 = self.now() if t1 is None else t1
        sp = Span(name=name, t0=t0, t1=t1, step=step, args=args,
                  u0=self.unix(t0), u1=self.unix(t1))
        self.spans.append(sp)
        return sp

    def time_on_device(self, sp: Span, start, end) -> None:
        """Give ``sp`` the device time between two recorded events (see
        :func:`cuda_mark`) as ``args["device_s"]``, read by the next
        :meth:`resolve_device` after the card has passed ``end``."""
        self._on_device.append((sp, start, end))

    def resolve_device(self) -> None:
        """Read the device time of every span whose end event the card has
        passed (``query`` does not synchronise); the rest wait."""
        left = []
        for sp, start, end in self._on_device:
            if end.query():
                sp.args["device_s"] = start.elapsed_time(end) / 1e3
            else:
                left.append((sp, start, end))
        self._on_device = left

    def gauge(self, name: str, value) -> None:
        self.gauges.append(Gauge(name=name, t=self.now(),
                                 value=float(value)))

    # -- derivation ----------------------------------------------------------
    def request_latency(self, req_id: int) -> RequestLatency:
        """Derive the request's latency record from its events.  Requires
        at least an ``enqueue``; missing downstream events yield 0.0 for
        the intervals they would bound."""
        evs = self._by_req.get(req_id)
        if not evs:
            raise ValueError(f"no events recorded for request {req_id}")
        t_enq = t_admit = t_first = t_rel = None
        toks: list[float] = []
        pending_preempt: Optional[float] = None
        preempt_delay = 0.0
        for ev in evs:
            if ev.kind == "enqueue" and t_enq is None:
                t_enq = ev.t
            elif ev.kind in ("admit", "readmit"):
                if t_admit is None:
                    t_admit = ev.t
                if ev.kind == "readmit" and pending_preempt is not None:
                    preempt_delay += ev.t - pending_preempt
                    pending_preempt = None
            elif ev.kind == "first_token" and t_first is None:
                t_first = ev.t
            elif ev.kind == "token":
                toks.append(ev.t)
            elif ev.kind == "preempt" and pending_preempt is None:
                pending_preempt = ev.t
            elif ev.kind == "release":
                t_rel = ev.t
        if t_enq is None:
            raise ValueError(f"request {req_id} has no enqueue event")
        gaps = tuple(b - a for a, b in zip(toks, toks[1:]))
        return RequestLatency(
            req_id=req_id,
            queue_wait=(t_admit - t_enq) if t_admit is not None else 0.0,
            ttft=(t_first - t_enq) if t_first is not None else 0.0,
            gaps=gaps,
            preempt_delay=preempt_delay,
            e2e=(t_rel - t_enq) if t_rel is not None else 0.0,
        )

    # -- Chrome trace-event export -------------------------------------------
    # One process ("repro-serving"); tid 0 is the phase timeline, tid 1
    # the queue (enqueue/preempt/readmit instants), tid 2+s decode slot s
    # (request occupancies as slices, lifecycle instants on top); gauges
    # are counter events.  Load the file at https://ui.perfetto.dev or
    # chrome://tracing.
    _PID = 1
    _TID_PHASES = 0
    _TID_QUEUE = 1
    _TID_SLOT0 = 2

    def to_chrome_trace(self) -> dict:
        us = 1e6
        out: list[dict] = []

        def meta(tid, name, sort_index):
            out.append({"name": "thread_name", "ph": "M", "ts": 0,
                        "pid": self._PID, "tid": tid,
                        "args": {"name": name}})
            out.append({"name": "thread_sort_index", "ph": "M", "ts": 0,
                        "pid": self._PID, "tid": tid,
                        "args": {"sort_index": sort_index}})

        out.append({"name": "process_name", "ph": "M", "ts": 0,
                    "pid": self._PID, "tid": 0,
                    "args": {"name": "repro-serving"}})
        meta(self._TID_PHASES, "phases", 0)
        meta(self._TID_QUEUE, "queue", 1)
        for sp in self.spans:
            out.append({"name": sp.name, "ph": "X",
                        "ts": round(sp.t0 * us, 3),
                        "dur": round(max(0.0, sp.t1 - sp.t0) * us, 3),
                        "pid": self._PID, "tid": self._TID_PHASES,
                        "args": {"step": sp.step, **sp.args}})
        # slot occupancy slices: open per row at admit/readmit, close at
        # release/preempt; anything still open closes at the trace end
        open_rows: dict[int, tuple] = {}     # slot -> (req_id, t0)
        used_slots: set = set()
        end_t = max((ev.t for ev in self.events), default=0.0)
        end_t = max(end_t, max((sp.t1 for sp in self.spans), default=0.0))

        def close(slot, t1):
            rid, t0 = open_rows.pop(slot)
            out.append({"name": f"req{rid}", "ph": "X",
                        "ts": round(t0 * us, 3),
                        "dur": round(max(0.0, t1 - t0) * us, 3),
                        "pid": self._PID, "tid": self._TID_SLOT0 + slot,
                        "args": {"req_id": rid}})

        def instant(name, ev, tid):
            out.append({"name": name, "ph": "i", "s": "t",
                        "ts": round(ev.t * us, 3),
                        "pid": self._PID, "tid": tid,
                        "args": {"req_id": ev.req_id, "step": ev.step,
                                 **ev.args}})

        req_rows: dict[int, list] = {}       # req -> rows last admitted
        for ev in self.events:
            if ev.kind in ("admit", "readmit"):
                rows = ev.args.get("rows", ())
                req_rows[ev.req_id] = list(rows)
                for r in rows:
                    if r in open_rows:       # defensive: close stale span
                        close(r, ev.t)
                    open_rows[r] = (ev.req_id, ev.t)
                    used_slots.add(r)
                instant(ev.kind, ev, self._TID_QUEUE)
            elif ev.kind in ("release", "preempt"):
                for r in ev.args.get("rows", ()):
                    if r in open_rows:
                        close(r, ev.t)
                if ev.kind == "preempt":
                    instant(ev.kind, ev, self._TID_QUEUE)
            elif ev.kind == "enqueue":
                instant(ev.kind, ev, self._TID_QUEUE)
            elif ev.kind == "beam_boundary":
                instant(ev.kind, ev, self._TID_PHASES)
            elif ev.kind in ("first_token", "token", "freeze", "resume"):
                rows = ev.args.get("rows") or req_rows.get(ev.req_id, ())
                tid = (self._TID_SLOT0 + rows[0]) if rows \
                    else self._TID_QUEUE
                instant(ev.kind, ev, tid)
        for slot in sorted(open_rows):
            close(slot, end_t)
        for g in self.gauges:
            out.append({"name": g.name, "ph": "C",
                        "ts": round(g.t * us, 3),
                        "pid": self._PID, "tid": self._TID_PHASES,
                        "args": {g.name: g.value}})
        for s in sorted(used_slots):
            meta(self._TID_SLOT0 + s, f"slot {s}", 2 + s)
        # metadata first, then by timestamp; at equal ts the longer span
        # sorts first so a parent that opens at the same instant as its
        # child precedes it (the balanced-nesting invariant the validator
        # checks)
        out.sort(key=lambda e: (e["ph"] != "M", e["ts"],
                                -e.get("dur", 0.0)))
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> str:
        trace = self.to_chrome_trace()
        bad = validate_chrome_trace(trace)
        if bad:  # never write a file the validator would reject
            raise ValueError(f"refusing to write invalid trace: {bad[:3]}")
        with open(path, "w") as f:
            json.dump(trace, f)
            f.write("\n")
        return path


# ---------------------------------------------------------------------------
# Chrome trace-event schema validation (the CI check)
# ---------------------------------------------------------------------------

_REQUIRED = ("name", "ph", "ts", "pid", "tid")
_PHASES_OK = {"M", "X", "i", "C"}


def validate_chrome_trace(obj) -> list[str]:
    """Structural validation of a Chrome trace-event JSON object.
    Returns violation strings (empty = valid):

    * top level: an object with a ``traceEvents`` list (non-empty);
    * every event carries ``name/ph/ts/pid/tid``, ``ph`` is one of
      M/X/i/C, ``ts`` is a non-negative number and ``X`` events carry a
      non-negative ``dur``;
    * non-metadata events are sorted by ``ts`` (monotone timeline);
    * per track (pid, tid), ``X`` spans are *balanced*: they nest or are
      disjoint, never partially overlap (a request's occupancy slices
      and the scheduler's phase slices must open and close in order);
    * every counter (``C``) event carries at least one numeric arg.
    """
    bad: list[str] = []
    if not isinstance(obj, dict) or not isinstance(
            obj.get("traceEvents"), list):
        return ["top level must be an object with a 'traceEvents' list"]
    evs = obj["traceEvents"]
    if not evs:
        bad.append("traceEvents is empty")
    last_ts = 0.0
    tracks: dict[tuple, list] = {}
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            bad.append(f"event {i}: not an object")
            continue
        missing = [k for k in _REQUIRED if k not in ev]
        if missing:
            bad.append(f"event {i}: missing keys {missing}")
            continue
        ph = ev["ph"]
        if ph not in _PHASES_OK:
            bad.append(f"event {i}: unknown phase {ph!r}")
            continue
        ts = ev["ts"]
        if not isinstance(ts, (int, float)) or ts < 0:
            bad.append(f"event {i} ({ev['name']}): bad ts {ts!r}")
            continue
        if ph == "M":
            continue
        if ts < last_ts - 1e-9:
            bad.append(f"event {i} ({ev['name']}): ts {ts} < previous "
                       f"{last_ts} (timeline not monotone)")
        last_ts = max(last_ts, ts)
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                bad.append(f"event {i} ({ev['name']}): X without "
                           f"non-negative dur (got {dur!r})")
            else:
                tracks.setdefault((ev["pid"], ev["tid"]), []).append(
                    (ts, ts + dur, ev["name"]))
        elif ph == "C":
            args = ev.get("args", {})
            if not any(isinstance(v, (int, float))
                       for v in args.values()):
                bad.append(f"event {i} ({ev['name']}): counter without "
                           f"a numeric arg")
    eps = 1e-3  # µs; guards float round-off in the containment check
    for (pid, tid), spans in tracks.items():
        stack: list[tuple] = []
        for t0, t1, name in spans:  # already ts-sorted per the check above
            while stack and t0 >= stack[-1][1] - eps:
                stack.pop()
            if stack and t1 > stack[-1][1] + eps:
                bad.append(
                    f"track ({pid},{tid}): span {name!r} [{t0},{t1}] "
                    f"partially overlaps {stack[-1][2]!r} "
                    f"[{stack[-1][0]},{stack[-1][1]}] (unbalanced)")
            stack.append((t0, t1, name))
    return bad


def main(argv=None) -> int:
    """``python -m repro_torch.serving.telemetry trace.json [...]`` —
    validate Chrome trace files; exits non-zero listing the violations."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("usage: python -m repro_torch.serving.telemetry "
              "TRACE.json [...]", file=sys.stderr)
        return 2
    rc = 0
    for path in argv:
        try:
            with open(path) as f:
                obj = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"{path}: unreadable ({e})", file=sys.stderr)
            rc = 1
            continue
        bad = validate_chrome_trace(obj)
        if bad:
            for msg in bad:
                print(f"{path}: {msg}", file=sys.stderr)
            rc = 1
        else:
            n = len(obj["traceEvents"])
            print(f"{path}: OK ({n} trace events)")
    return rc


if __name__ == "__main__":
    sys.exit(main())
