#!/usr/bin/env python3
"""Run one benchmark cell on the card and show where the card idles
inside the tracer's spans, and what tracing costs.

    python3 scripts/span_idle.py --workload qwen2.5-1.5b.bon16-gsm8k \\
        --seed 7 --seconds 51 --mode off|tracer|traced

One run a process, one JSON line on stdout.  ``off``: the untraced run
(the benchmark's ``--trace 0``), its result line's metrics and the
window's mean step wall.  ``tracer``: the traced run with
``torch.profiler`` left out (never started, not even warmed up), so the
tracer alone: the mean step wall and ``decode`` span.  ``traced``: the
benchmark's ``--trace 1`` run, its result line, and ``spans``: for the
profiled steps, each span name's count, host ms and the card's idle ms
per profiled step, every span placed on the device trace's clock by its
own Unix stamps; ``decode``'s idle against the sum over its children
(``plan``, ``sample``, ``forward``, ``readback``) and its self time;
the mean step wall and ``decode`` span of the window's steps outside the
profiled ones (the tracer, after the profiler's warm-up) and inside them
(the tracer and ``torch.profiler``).
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "perfbench"), str(ROOT / "src")]

CHILDREN = ("plan", "sample", "forward", "readback")


def _captured(bench):
    """Patch the harness so one run leaves its tracer, window, device
    trace and the scheduler's metrics (not the scheduler: the engine is
    freed before the reference runs) behind."""
    from benchlib import devtrace as DT
    from benchlib import loop as LP
    from repro_torch.serving import telemetry

    got = {}
    tracer_cls, run_window, stop, build = (
        telemetry.Tracer, LP.run_window, DT.Profiler.stop, LP.build)

    class Kept(tracer_cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            got["tracer"] = self

    def window(*a, **k):
        out = run_window(*a, **k)
        got["window"] = out[1]
        return out

    def stopped(self, *a, **k):
        got["device"] = stop(self, *a, **k)
        return got["device"]

    def built(*a, **k):
        sched, engine = build(*a, **k)
        got["metrics"] = sched.metrics
        return sched, engine

    telemetry.Tracer, LP.run_window, DT.Profiler.stop, LP.build = (
        Kept, window, stopped, built)
    return got


class _NoProfiler:
    """Stands in for the harness's profiler: never starts."""

    def __init__(self):
        self.prof = None

    @staticmethod
    def warm() -> None:
        pass

    def start(self, clock, step: int) -> None:
        self.prof = False        # not None: asked once

    def stop(self, clock, step: int):
        return None


def step_walls(got) -> dict:
    """{step: host wall s} of the window's steps."""
    steps = {r.step for r in got["window"].steps}
    return {r.step: r.wall_s for r in got["metrics"].records
            if r.step in steps}


def _minus(span, others) -> list:
    """[u0, u1] pieces of ``span`` that no span of ``others`` covers."""
    pieces = [(span.u0, span.u1)]
    for o in sorted(others, key=lambda s: s.u0):
        nxt = []
        for a, b in pieces:
            if o.u1 <= a or o.u0 >= b:
                nxt.append((a, b))
                continue
            if o.u0 > a:
                nxt.append((a, o.u0))
            if o.u1 < b:
                nxt.append((o.u1, b))
        pieces = nxt
    return pieces


def analyse(got) -> dict:
    from benchlib import devclock as DC
    from benchlib import devtrace as DT

    tr, dev = got["tracer"], got["device"]
    n = dev.step1 - dev.step0
    spans = {}
    for name in sorted({s.name for s in tr.spans}):
        sel = DC.profiled_spans(tr.spans, dev, name)
        spans[name] = {"count": len(sel),
                       "host_ms_per_step": 1e3 * sum(
                           s.u1 - s.u0 for s in sel) / n,
                       "idle_ms_per_step": 1e3 * DC.idle_s(
                           sel, dev.ops) / n}
    decodes = DC.profiled_spans(tr.spans, dev, "decode")
    kids = {c: DC.profiled_spans(tr.spans, dev, c) for c in CHILDREN}
    self_idle = 0.0
    overlap = 0.0
    for d in decodes:
        # a decode's children, found on the tracer's own clock
        inner = [k for c in CHILDREN for k in kids[c]
                 if d.t0 <= k.t0 and k.t1 <= d.t1]
        rest = [SimpleNamespace(u0=a, u1=b) for a, b in _minus(d, inner)]
        self_idle += DC.idle_s(rest, dev.ops)
        inner.sort(key=lambda s: s.u0)
        overlap += sum(max(0.0, a.u1 - b.u0)
                       for a, b in zip(inner, inner[1:]))
    dec_idle = DC.idle_s(decodes, dev.ops)
    kid_idle = sum(DC.idle_s(kids[c], dev.ops) for c in CHILDREN)
    walls = step_walls(got)
    inside = [s for s in walls if dev.step0 <= s < dev.step1]
    outside = [s for s in walls if not dev.step0 <= s < dev.step1]
    dec_by_step = {s.step: s.t1 - s.t0 for s in tr.spans
                   if s.name == "decode"}

    def mean_ms(xs):
        return 1e3 * statistics.fmean(xs) if xs else None

    return {
        "profiled_steps": n, "window_s": dev.window_s,
        "busy_s": DT.busy_s(dev.ops),
        "spans": spans,
        "decode_split_ms_per_step": {
            "decode_idle": 1e3 * dec_idle / n,
            "children_idle": {c: 1e3 * DC.idle_s(kids[c], dev.ops) / n
                              for c in CHILDREN},
            "self_idle": 1e3 * self_idle / n,
            "children_plus_self": 1e3 * (kid_idle + self_idle) / n,
            "children_overlap_ms": 1e3 * overlap},
        "step_wall_ms": {"tracer": mean_ms([walls[s] for s in outside]),
                         "tracer_and_profiler": mean_ms(
                             [walls[s] for s in inside])},
        "decode_span_ms": {
            "tracer": mean_ms([dec_by_step[s] for s in outside
                               if s in dec_by_step]),
            "tracer_and_profiler": mean_ms([dec_by_step[s] for s in inside
                                            if s in dec_by_step])},
        "steps": {"tracer": len(outside), "tracer_and_profiler":
                  len(inside)},
        "device_op_names_with_event_or_sync": sorted({
            o[0] for o in dev.ops
            if "event" in o[0].lower() or "sync" in o[0].lower()}),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--mode", choices=("off", "tracer", "traced"),
                    required=True)
    args = ap.parse_args(argv)
    import torch

    from benchlib import bench, spec
    from benchlib import devtrace as DT

    torch.set_num_threads(1)
    cell = spec.resolve(args.workload)
    got = _captured(bench)
    if args.mode == "tracer":
        DT.Profiler = _NoProfiler
    out = bench.run(cell, args.seed, args.seconds, args.mode != "off",
                    t_start=T_START)
    line = {"mode": args.mode, "metrics": out["metrics"],
            "correct": out["correct"], "device": out["device"]}
    walls = step_walls(got)
    line["step_wall_ms"] = 1e3 * statistics.fmean(walls.values())
    line["steps"] = len(walls)
    if args.mode == "tracer":
        dec = [s.t1 - s.t0 for s in got["tracer"].spans
               if s.name == "decode" and s.step in walls]
        line["decode_span_ms"] = 1e3 * statistics.fmean(dec)
    if args.mode == "traced":
        line["breakdown"] = out.get("breakdown")
        line["spans"] = analyse(got)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
