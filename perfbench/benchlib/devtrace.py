"""The device's side of a traced run: ``torch.profiler`` over the last
seconds of the window, read as intervals of device activity (kernels,
copies, sets) with their names."""
from __future__ import annotations

import bisect
import re
import time
from dataclasses import dataclass, field

import torch


@dataclass
class DeviceTrace:
    host_t0: float = 0.0       # loop clock at the profiler's start
    host_t1: float = 0.0
    unix_t0: float = 0.0       # wall clock then, seconds
    step0: int = 0             # first step profiled
    step1: int = 0             # one past the last
    ops: list = field(default_factory=list)   # (name, start_s, dur_s)
    k3_shapes: dict = field(default_factory=dict)
    k2_launches: int = 0
    start_s: float = 0.0       # host time the profiler's start took

    @property
    def window_s(self) -> float:
        return self.host_t1 - self.host_t0


class Profiler:
    """Starts at a step boundary, stops at another; the device is idle at
    both (each step ends with a copy of tokens to the host)."""

    def __init__(self):
        self.prof = None
        self.trace = DeviceTrace()

    @staticmethod
    def warm() -> None:
        """Profile one tiny op, so the tracer's one-time start-up cost
        lands in set-up and not in the window."""
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self, clock, step: int) -> None:
        from repro_torch.kernels import ops

        torch.cuda.synchronize()
        t = clock()
        ops.reset_launch_counts()
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        self.trace.step0 = step
        self.trace.unix_t0 = time.time()
        self.trace.host_t0 = clock()
        self.trace.start_s = self.trace.host_t0 - t

    def stop(self, clock, step: int) -> DeviceTrace:
        from repro_torch.kernels import ops

        torch.cuda.synchronize()
        self.trace.host_t1 = clock()
        self.trace.step1 = step
        self.prof.stop()
        self.trace.k3_shapes = ops.gemm_launches_by_shape()
        self.trace.k2_launches = ops.launch_counts()["quant_paged_attention"]
        self.trace.ops = device_ops(self.prof)
        return self.trace


def _ns(ev, what: str) -> float:
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return float(f())
    return float(getattr(ev, f"{what}_us")()) * 1e3


def device_ops(prof) -> list:
    """(name, start seconds, duration seconds) of every device activity
    the profiler saw, in start order."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        out.append((ev.name(), _ns(ev, "start") * 1e-9,
                    _ns(ev, "duration") * 1e-9))
    out.sort(key=lambda e: e[1])
    return out


def union(ops) -> list:
    """Merged [start, end) intervals of (name, start, dur) in start
    order."""
    merged: list = []
    for _, s, d in ops:
        e = s + d
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_s(ops) -> float:
    return sum(e - s for s, e in union(ops))


def kernel_s(ops, pattern: str) -> float:
    """Device seconds of the activities whose name matches ``pattern``."""
    rx = re.compile(pattern)
    return sum(d for n, _, d in ops if rx.search(n))


def short_name(name: str) -> str:
    """A kernel's name without return type, template arguments or
    parameters, at most 96 characters."""
    n = name[5:] if name.startswith("void ") else name
    for stop in "<(":
        i = n.find(stop)
        if i > 0:
            n = n[:i]
    return n[:96]


def top_ops(ops, k: int = 10) -> list:
    by: dict = {}
    for n, _, d in ops:
        key = short_name(n)
        by[key] = by.get(key, 0.0) + d
    return sorted(([n, s] for n, s in by.items()), key=lambda x: -x[1])[:k]


def idle_gaps(ops, spans, to_host, k: int = 10) -> list:
    """Idle device time summed by the innermost host span open at each
    gap's middle (``to_host`` maps a device time to the loop's clock;
    "harness" where no span of the program is open)."""
    iv = union(ops)
    if len(iv) < 2:
        return []
    lo, hi = to_host(iv[0][1]), to_host(iv[-1][0])
    spans = [sp for sp in spans if sp.t1 >= lo and sp.t0 <= hi]
    # elementary intervals between span boundaries, each named by the
    # shortest span covering it
    cuts = sorted({t for sp in spans for t in (sp.t0, sp.t1)})
    names = []
    for a, b in zip(cuts, cuts[1:]):
        m = (a + b) / 2
        cover = [sp for sp in spans if sp.t0 <= m <= sp.t1]
        names.append(min(cover, key=lambda sp: sp.t1 - sp.t0).name
                     if cover else "harness")
    by: dict = {}
    for (_, e0), (s1, _) in zip(iv, iv[1:]):
        i = bisect.bisect_right(cuts, to_host((e0 + s1) / 2)) - 1
        name = names[i] if 0 <= i < len(names) else "harness"
        by[name] = by.get(name, 0.0) + (s1 - e0)
    return sorted(([n, s] for n, s in by.items()), key=lambda x: -x[1])[:k]
