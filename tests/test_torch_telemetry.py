"""The port's request tracer against the JAX package's.

``repro_torch.serving.telemetry`` is a copy of the JAX module; its unit
behaviour (percentiles, latency derivation on a scripted schedule, the
Chrome-trace validator, file write and CLI) is checked here on the
port's module and held to the JAX module's results.  Then the port's
scheduler and the JAX scheduler serve one workload from the same random
``tiny_cfg`` weights (a beam tree, plain requests and a Best-of-N group
on a starved pool, so the youngest request is preempted): their
``(kind, req_id, step)`` event sequences (with each event's arguments)
and ``(name, step)`` span sequences (the port's filtered to the JAX
package's span names) are equal, the port's trace passes both packages'
validators, ``summary()`` has the JAX package's key set, and
``tracer=None`` leaves the tokens bit-identical.  The spans the port
adds inside the step (``sample``, ``forward``, ``readback``,
``gather``) and their Unix stamps are checked on their own.  Last, the
speculative rounds' telemetry (``tests/test_spec_decode.py``'s
``test_spec_telemetry_and_profiler_threading``) on both packages."""
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import api as japi
from repro.serving import telemetry as JT
from repro.serving.engine import BeamSpec as JBeamSpec
from repro.serving.engine import ContinuousScheduler as JScheduler
from repro.serving.engine import DecodeEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.engine import SpecConfig as JSpecConfig
from repro.serving.profiling import KernelProfiler as JKernelProfiler
from repro.serving.sampler import SamplerConfig as JSampler
from repro_torch import bridge
from repro_torch.configs.base import ModelConfig
from repro_torch.serving.engine import (BeamSpec, ContinuousScheduler,
                                        DecodeEngine, Request, SpecConfig)
from repro_torch.serving.profiling import KernelProfiler
from repro_torch.serving import telemetry as PT
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.serving.telemetry import (Tracer, main, percentile,
                                           validate_chrome_trace)

NO_STOP = (9999,)
GREEDY, JGREEDY = SamplerConfig(greedy=True), JSampler(greedy=True)
PROMPT_LEN = 16


def _torch_cfg(cfg):
    return ModelConfig(**{f: getattr(cfg, f) for f in (
        "name", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
        "vocab_size", "dtype", "param_dtype")})


def _counting_clock(tick_s=1e-3):
    c = itertools.count()
    return lambda: next(c) * tick_s


class ManualClock:
    """Set ``.t`` before each tracer call to script exact timestamps."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def weights(tiny_cfg):
    jp = japi.get_model(tiny_cfg).init_params(jax.random.key(11), tiny_cfg)
    return jp, bridge.params_from_jax(jax.device_get(jp), device="cpu")


def _engines(weights, tiny_cfg, tok, n_blocks):
    kw = dict(max_len=64, eos_id=tok.eos_id, pad_id=tok.pad_id, paged=True,
              block_size=8, n_blocks=n_blocks)
    return (JEngine(weights[0], tiny_cfg, **kw),
            DecodeEngine(weights[1], _torch_cfg(tiny_cfg), **kw))


# ---------------------------------------------------------------------------
# Tracer unit behaviour (no scheduler), held to the JAX module
# ---------------------------------------------------------------------------


def _scripted(mod):
    """Three scripted requests on ``mod.Tracer`` under a manual clock."""
    c = ManualClock()
    tr = mod.Tracer(clock=c)

    def at(t, kind, rid, **args):
        c.t = t
        tr.event(kind, rid, **args)

    at(1.0, "enqueue", 0)
    at(2.0, "admit", 0, rows=[0])
    at(3.0, "first_token", 0)
    at(3.0, "token", 0)
    at(5.0, "token", 0)
    at(8.0, "token", 0)
    at(9.0, "release", 0, rows=[0])
    at(1.5, "enqueue", 1)
    at(2.0, "admit", 1, rows=[1])
    at(3.0, "first_token", 1)
    at(3.0, "token", 1)
    at(6.0, "preempt", 1, rows=[1])
    at(7.0, "readmit", 1, rows=[1])
    at(9.0, "token", 1)
    at(10.0, "release", 1, rows=[1])
    at(4.0, "enqueue", 2)
    return tr


@pytest.mark.parametrize("case", ["percentile", "scripted_schedule",
                                  "validator_negatives", "write_and_cli"])
def test_tracer_unit(case, tmp_path, capsys):
    if case == "percentile":
        assert percentile([], 99) == 0.0
        assert percentile([1.0, 2.0, 3.0], 50) == 2.0
        xs = [0.3, 0.1, 0.7, 0.2, 0.9]
        for q in (50, 90, 99):
            assert percentile(xs, q) == JT.percentile(xs, q)
    elif case == "scripted_schedule":
        tr, jtr = _scripted(PT), _scripted(JT)
        r0 = tr.request_latency(0)
        assert r0.queue_wait == 1.0 and r0.ttft == 2.0
        assert r0.gaps == (2.0, 3.0)
        assert r0.preempt_delay == 0.0 and r0.e2e == 8.0
        r1 = tr.request_latency(1)
        assert r1.queue_wait == 0.5 and r1.ttft == 1.5
        assert r1.gaps == (6.0,)        # 3.0 -> 9.0 spans the requeue
        assert r1.preempt_delay == 1.0 and r1.e2e == 8.5
        r2 = tr.request_latency(2)
        assert r2.queue_wait == r2.ttft == r2.e2e == 0.0 and r2.gaps == ()
        with pytest.raises(ValueError, match="no events"):
            tr.request_latency(99)
        for rid in range(3):
            lat, jlat = tr.request_latency(rid), jtr.request_latency(rid)
            # the JAX record's fields the port keeps
            assert lat.__dict__ == {k: getattr(jlat, k)
                                    for k in lat.__dict__}
        trace = tr.to_chrome_trace()
        assert trace == jtr.to_chrome_trace()
        assert validate_chrome_trace(trace) == []
        slices = [e for e in trace["traceEvents"]
                  if e["ph"] == "X" and e["name"].startswith("req")]
        assert {e["name"] for e in slices} == {"req0", "req1"}
    elif case == "validator_negatives":
        cases = [[], {}, {"traceEvents": []}]
        base = {"name": "x", "ph": "i", "s": "t", "ts": 1.0, "pid": 1,
                "tid": 0}
        for ev in ({k: v for k, v in base.items() if k != "pid"},
                   {**base, "ph": "Z"}, {**base, "ts": -1.0},
                   {**base, "ph": "X"},
                   {**base, "ph": "C", "args": {"note": "nan"}}):
            cases.append({"traceEvents": [ev]})
        cases.append({"traceEvents": [{**base, "ts": 5.0},
                                      {**base, "ts": 1.0}]})
        x = {"ph": "X", "pid": 1, "tid": 0}
        cases.append({"traceEvents": [
            {**x, "name": "a", "ts": 0.0, "dur": 10.0},
            {**x, "name": "b", "ts": 5.0, "dur": 10.0}]})
        for obj in cases:
            got = validate_chrome_trace(obj)
            assert got and got == JT.validate_chrome_trace(obj)
        assert any("partially overlaps" in b for b in got)
        ok = {"traceEvents": [
            {**x, "name": "a", "ts": 0.0, "dur": 10.0},
            {**x, "name": "b", "ts": 2.0, "dur": 3.0},
            {**x, "name": "c", "ts": 6.0, "dur": 4.0},
            {**x, "name": "d", "ts": 20.0, "dur": 1.0}]}
        assert validate_chrome_trace(ok) == []
    else:
        c = ManualClock()
        tr = Tracer(clock=c)
        for t, kind in ((1.0, "enqueue"), (2.0, "admit"), (3.0, "release")):
            c.t = t
            tr.event(kind, 0, rows=[0])
        tr.gauge("occupancy", 1)
        path = str(tmp_path / "trace.json")
        tr.write_chrome_trace(path)
        assert JT.validate_chrome_trace(json.load(open(path))) == []
        assert main([path]) == 0 and JT.main([path]) == 0
        assert "OK" in capsys.readouterr().out
        bad = str(tmp_path / "bad.json")
        json.dump({"traceEvents": [{"name": "x", "ph": "X", "ts": -4.0,
                                    "pid": 1, "tid": 0}]}, open(bad, "w"))
        assert main([bad]) == 1
        assert main([str(tmp_path / "missing.json")]) == 1
        assert main([]) == 2


# ---------------------------------------------------------------------------
# The scheduler's event stream against the JAX scheduler's
# ---------------------------------------------------------------------------


def _workload(engine, tok, *, ref, tracer):
    """A beam tree (2 x 2 lanes, delimiter never sampled: every lane
    freezes at its step budget), two plain requests and a Best-of-2 group
    in 6 slots over a 10-block pool: growth preempts the youngest."""
    sched_cls, req_cls, spec_cls = (JScheduler, JRequest, JBeamSpec) if ref \
        else (ContinuousScheduler, Request, BeamSpec)

    def prompt(text):
        ids = tok.encode(text)
        return jnp.asarray(ids) if ref else torch.tensor(ids,
                                                         dtype=torch.int32)

    def score(token_lists, lp, ng):
        return np.asarray(lp) / np.maximum(np.asarray(ng), 1)

    sched = sched_cls(engine, n_slots=6, prompt_len=PROMPT_LEN,
                      stop_ids=NO_STOP, tracer=tracer)
    sched.submit(req_cls(req_id=0, prompt=prompt("Q:12+34=?A:"),
                         search=spec_cls(
                             width=2, expand=2, step_tokens=6, max_steps=2,
                             step_stop_id=int(tok.encode("z", bos=False)[0]),
                             score=score)))
    sched.submit(req_cls(req_id=1, prompt=prompt("Q:7+5=?A:"),
                         max_new_tokens=10))
    sched.submit(req_cls(req_id=2, prompt=prompt("Q:19+23=?A:"),
                         max_new_tokens=10))
    sched.submit(req_cls(req_id=3, prompt=prompt("Q:2+2=?A:"),
                         max_new_tokens=8, n_samples=2))
    res = sched.run(jax.random.key(0) if ref else None,
                    JGREEDY if ref else GREEDY)
    return sched, res


def _events(tr):
    return [(e.kind, e.req_id, e.step, json.dumps(e.args, sort_keys=True))
            for e in tr.events]


def _spans(tr, names=None):
    return [(s.name, s.step) for s in tr.spans
            if names is None or s.name in names]


def test_scheduler_trace_matches_reference(weights, tiny_cfg, tok):
    jeng, teng = _engines(weights, tiny_cfg, tok, n_blocks=10)
    jtr, tr = JT.Tracer(clock=_counting_clock()), \
        Tracer(clock=_counting_clock())
    jsched, want = _workload(jeng, tok, ref=True, tracer=jtr)
    sched, got = _workload(teng, tok, ref=False, tracer=tr)
    assert got == want and set(got) == {0, 1, 2, 3}
    s, ws = sched.metrics.summary(), jsched.metrics.summary()
    assert s["preemptions"] >= 1 and s["preemptions"] == ws["preemptions"]
    assert s["beam_boundaries"] == ws["beam_boundaries"] >= 1
    kinds = {e.kind for e in tr.events}
    assert kinds >= {"enqueue", "admit", "readmit", "first_token", "token",
                     "freeze", "resume", "beam_boundary", "preempt",
                     "release"}
    assert _events(tr) == _events(jtr)
    # the port's spans inside the step are its own (checked below)
    assert _spans(tr, JT.SPAN_NAMES) == _spans(jtr)
    assert [g.name for g in tr.gauges] == [g.name for g in jtr.gauges]
    # gauges that count, not time, agree in value too
    counted = ("occupancy", "free_blocks")
    assert [g.value for g in tr.gauges if g.name in counted] == \
        [g.value for g in jtr.gauges if g.name in counted]
    trace = tr.to_chrome_trace()
    assert validate_chrome_trace(trace) == []
    assert JT.validate_chrome_trace(json.loads(json.dumps(trace))) == []
    # the summary's key set is the JAX package's, latency keys filled in
    assert set(s) == set(ws)
    assert s["latency_requests"] == ws["latency_requests"] == 4
    assert s["preempt_delay_s"] > 0
    for rid in range(4):
        lat, wlat = tr.request_latency(rid), jtr.request_latency(rid)
        assert len(lat.gaps) == len(wlat.gaps)
    assert teng.pool.blocks_in_use == 0


def test_null_tracer_parity_and_summary_keys(weights, tiny_cfg, tok):
    """tracer=None (the default) changes nothing: the same tokens as a
    traced run, every latency key present (0 where only a tracer fills
    it in), and the key set of a tracer-less JAX summary."""
    jeng, teng = _engines(weights, tiny_cfg, tok, n_blocks=10)
    off, got_off = _workload(teng, tok, ref=False, tracer=None)
    on, got_on = _workload(teng, tok, ref=False,
                           tracer=Tracer(clock=_counting_clock()))
    assert got_off == got_on
    assert all(a.tokens == b.tokens and a.logprob_sum == b.logprob_sum
               for rid in got_off
               for a, b in zip(off.completed[rid], on.completed[rid]))
    s = off.metrics.summary()
    assert s["latency_requests"] == 0
    assert s["ttft_p50"] == s["itl_p99"] == s["queue_wait_p99"] == 0.0
    assert s["step_time_p99"] >= s["step_time_p50"] > 0.0
    assert on.metrics.summary()["latency_requests"] == 4
    empty = JScheduler(jeng, n_slots=2, prompt_len=PROMPT_LEN)
    assert set(s) == set(empty.metrics.summary())
    idle = ContinuousScheduler(teng, n_slots=2, prompt_len=PROMPT_LEN)
    assert idle.run(None, GREEDY) == {}
    assert all(v == 0 for k, v in idle.metrics.summary().items()
               if k not in ("n_slots", "kv_quant"))


def test_spec_telemetry_and_profiler_threading(weights, tiny_cfg, tok):
    """Speculative rounds land in the tracer (one ``spec_verify`` span
    and one ``spec_accepted_tokens`` gauge per round) and in the
    profiler's phases, with the same rounds, spans and gauge values as
    the JAX scheduler."""
    reqs = [("Q:2+7=?A:", 12), ("Q:1+1=?A:", 6), ("Q:9+9=?A:", 10),
            ("Q:4+5=?A:", 8)]
    out = []
    for ref in (True, False):
        jeng, teng = _engines(weights, tiny_cfg, tok, n_blocks=48)
        tracer = (JT.Tracer if ref else Tracer)(clock=_counting_clock())
        prof = (JKernelProfiler if ref else KernelProfiler)(
            sample_rate=1.0, canary_rate=0.0)
        sched = (JScheduler if ref else ContinuousScheduler)(
            jeng if ref else teng, n_slots=3, prompt_len=PROMPT_LEN,
            stop_ids=NO_STOP, tracer=tracer, profiler=prof,
            spec=(JSpecConfig if ref else SpecConfig)(k=4, self_draft=True))
        for i, (text, max_new) in enumerate(reqs):
            ids = tok.encode(text)
            sched.submit((JRequest if ref else Request)(
                req_id=i, prompt=jnp.asarray(ids) if ref else torch.tensor(
                    ids, dtype=torch.int32), max_new_tokens=max_new))
        try:
            res = sched.run(jax.random.key(0) if ref else None,
                            JGREEDY if ref else GREEDY)
        finally:
            prof.uninstall()
        s = sched.metrics.summary()
        spans = [sp for sp in tracer.spans if sp.name == "spec_verify"]
        assert len(spans) == s["spec_rounds"] > 0
        gauges = [g.value for g in tracer.gauges
                  if g.name == "spec_accepted_tokens"]
        assert len(gauges) == s["spec_rounds"] and sum(gauges) > 0
        phases = prof.report()["phases"]
        assert phases["spec_verify"]["calls"] == s["spec_rounds"]
        # a round that falls back to a plain step also records the
        # port's spans inside the step, which the JAX package lacks
        out.append((res, s["spec_rounds"], gauges,
                    _spans(tracer, JT.SPAN_NAMES + ("spec_verify",))))
        if not ref:
            assert validate_chrome_trace(tracer.to_chrome_trace()) == []
            assert teng.pool.blocks_in_use == 0
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# The port's spans inside the step, on the device trace's clock
# ---------------------------------------------------------------------------

STEP_SPANS = ("plan", "sample", "forward", "readback")


class LockstepClocks:
    """A tick clock of binary-exact ticks, and a Unix clock a second
    further on at each of its reads: each anchor takes reads of its own,
    so a span's stamps show which anchor placed it, exactly."""

    TICK = 2.0 ** -10
    BASE_NS = 1000 * 10 ** 9

    def __init__(self):
        self.n = 0
        self.unix_reads = 0

    def clock(self):
        self.n += 1
        return self.n * self.TICK

    def unix(self):
        self.unix_reads += 1
        return self.BASE_NS + self.unix_reads * 10 ** 9


def _port_engine(weights, tiny_cfg, tok, n_blocks):
    return DecodeEngine(weights[1], _torch_cfg(tiny_cfg), max_len=64,
                        eos_id=tok.eos_id, pad_id=tok.pad_id, paged=True,
                        block_size=8, n_blocks=n_blocks)


def _inside(sp, outer):
    return outer.t0 <= sp.t0 and sp.t1 <= outer.t1


def _by_parent(tr, parent, names):
    """{parent span index: [its spans of ``names`` in order]}."""
    parents = [s for s in tr.spans if s.name == parent]
    got = {i: [] for i in range(len(parents))}
    for sp in tr.spans:
        if sp.name in names:
            owner = [i for i, p in enumerate(parents) if _inside(sp, p)]
            assert len(owner) == 1, (sp, owner)
            got[owner[0]].append(sp)
    return parents, got


def _check_step_spans(tr, n_steps):
    """One plan, sample, forward and readback span per plain decode
    step, in that order inside its ``decode``, none overlapping, the
    forward starting where the sample ends; the trace validates."""
    decodes, kids = _by_parent(tr, "decode", STEP_SPANS)
    assert len(decodes) == n_steps
    for i, dec in enumerate(decodes):
        names = [sp.name for sp in sorted(kids[i], key=lambda s: s.t0)]
        assert names == list(STEP_SPANS), names
        ordered = sorted(kids[i], key=lambda s: s.t0)
        for a, b in zip(ordered, ordered[1:]):
            assert a.t1 <= b.t0
        assert ordered[2].t0 == ordered[1].t1
        assert ordered[3].step == dec.step
    # on the CPU no event is recorded, so no span has device time
    assert not any("device_s" in sp.args for sp in tr.spans)
    assert validate_chrome_trace(tr.to_chrome_trace()) == []


def test_step_spans_nest_and_carry_unix_stamps(weights, tiny_cfg, tok):
    """The preempting beam + chat + Best-of-N workload: every plain step
    has its four spans inside ``decode``; no ``gather`` without a cache;
    every span's ``u0`` / ``u1`` is its ``t0`` / ``t1`` placed by the
    anchor its step took (one Unix read of its own per step)."""
    clocks = LockstepClocks()
    tr = Tracer(clock=clocks.clock, unix_clock=clocks.unix)
    sched, _ = _workload(_port_engine(weights, tiny_cfg, tok, 10), tok,
                         ref=False, tracer=tr)
    _check_step_spans(tr, sched.step_count)
    assert not any(sp.name == "gather" for sp in tr.spans)
    steps = [s for s in tr.spans if s.name == "step"]
    assert [s.step for s in steps] == list(range(sched.step_count))
    reads, tick = PT.ANCHOR_READS, LockstepClocks.TICK
    for k, st in enumerate(steps, start=1):
        # anchor k (0 is the tracer's own) took the first of its reads:
        # Unix read k * reads + 1, at the middle of its two clock reads,
        # reads - 0.5 ticks before the step opened
        u_k = 1000.0 + k * reads + 1
        c_k = st.t0 - (reads - 0.5) * tick
        inner = [sp for sp in tr.spans if _inside(sp, st)]
        assert len(inner) > 1
        for sp in inner:
            assert sp.u0 == u_k + (sp.t0 - c_k)
            assert sp.u1 == u_k + (sp.t1 - c_k)
    # only the idle call that ends the drain is outside every step
    outside = [sp for sp in tr.spans
               if not any(_inside(sp, st) for st in steps)]
    assert [sp.name for sp in outside] == ["admit"]


def test_canary_replica_records_no_step_spans(weights, tiny_cfg, tok):
    """A canary on every step re-runs the step on the exact path; only
    the production step records ``sample`` and ``forward``."""
    teng = _port_engine(weights, tiny_cfg, tok, 48)
    replicas = []
    core = teng._canary_step

    def counted(*a, **k):
        replicas.append(1)
        return core(*a, **k)

    teng._canary_step = counted
    tr = Tracer(clock=_counting_clock())
    prof = KernelProfiler(sample_rate=1.0, canary_rate=1.0)
    sched = ContinuousScheduler(teng, n_slots=3, prompt_len=PROMPT_LEN,
                                stop_ids=NO_STOP, tracer=tr, profiler=prof)
    for i, text in enumerate(("Q:2+7=?A:", "Q:1+1=?A:")):
        sched.submit(Request(req_id=i, prompt=torch.tensor(
            tok.encode(text), dtype=torch.int32), max_new_tokens=5,
            n_samples=1 + i))
    try:
        sched.run(None, GREEDY)
    finally:
        prof.uninstall()
    assert len(replicas) == sched.step_count > 0
    _check_step_spans(tr, sched.step_count)


def test_gather_only_on_a_cached_prefill(weights, tiny_cfg, tok):
    """With the prefix cache, each cached prefill holds one ``gather``
    span and every other prefill none."""
    from repro_torch.serving.prefix_cache import PrefixCache

    teng = _port_engine(weights, tiny_cfg, tok, 48)
    tr = Tracer(clock=_counting_clock())
    sched = ContinuousScheduler(teng, n_slots=4, prompt_len=40,
                                stop_ids=NO_STOP, tracer=tr,
                                prefix_cache=PrefixCache(teng.pool))
    header = "Shots: 1+1=2. 2+2=4. 3+3=6. "
    texts = [header + "Q:2+7=?A:", header + "Q:5+1=?A:", "Q:9+9=?A:",
             header + "Q:4+4=?A:"]
    for i, text in enumerate(texts):
        sched.submit(Request(req_id=i, prompt=torch.tensor(
            tok.encode(text), dtype=torch.int32), max_new_tokens=4,
            n_samples=2 if i == 3 else 1))
    sched.run(None, GREEDY)
    prefills, kids = _by_parent(tr, "prefill", ("gather",))
    cached = [i for i, p in enumerate(prefills) if p.args["cached"]]
    assert cached and len(cached) < len(prefills)
    assert sched.metrics.summary()["prefill_tokens_saved"] > 0
    for i in range(len(prefills)):
        assert len(kids[i]) == (1 if i in cached else 0)
    _check_step_spans(tr, sched.step_count)


class _Event:
    """A stand-in for a CUDA timing event: ``ms`` on the card's clock,
    passed once ``passed`` is set."""

    def __init__(self, ms, passed=True):
        self.ms, self.passed = ms, passed

    def query(self):
        return self.passed

    def elapsed_time(self, end):
        assert self.passed and end.passed
        return end.ms - self.ms


def test_device_time_waits_for_the_card():
    """``device_s`` is read only once the end event has passed, and
    only for the span it was given to."""
    c = ManualClock()
    tr = Tracer(clock=c, unix_clock=lambda: 5 * 10 ** 9)
    a, b = tr.span("sample", 0.0), tr.span("forward", 0.0)
    late = _Event(10.5, passed=False)
    tr.time_on_device(a, _Event(2.0), _Event(2.25))
    tr.time_on_device(b, _Event(4.0), late)
    tr.resolve_device()
    assert a.args == {"device_s": 0.25e-3}
    assert "device_s" not in b.args
    late.passed = True
    tr.resolve_device()
    assert b.args == {"device_s": 6.5e-3}
    assert a.u0 == a.u1 == 5.0
    trace = tr.to_chrome_trace()
    assert validate_chrome_trace(trace) == []
    assert [e["args"].get("device_s") for e in trace["traceEvents"]
            if e["ph"] == "X"] == [0.25e-3, 6.5e-3]
