"""The readers of the spans inside the decode step: the card's idle time
inside ``forward`` and ``prefill`` spans placed by their own Unix stamps,
the sampler's device time and the host's wait at the step's end, on
synthetic runs with answers worked out by hand."""
import json
from types import SimpleNamespace

import pytest

from tiny import ROOT

from benchlib import devclock as DC
from benchlib import devtrace as DT
from benchlib import spec
from repro_torch.serving.telemetry import Span

NEW = ("sample_device_ms_per_step", "readback_ms_per_step",
       "forward_idle_ms_per_step", "prefill_idle_ms_per_step")


def _span(name, u0, u1, t0=0.0, t1=0.0, **args):
    return Span(name=name, t0=t0, t1=t1, args=args, u0=u0, u1=u1)


def _device():
    """Busy [10, 11.5] (two overlapping kernels) and [13, 13.5], in a
    window of [9, 15] on the Unix clock over steps 3 and 4."""
    return DT.DeviceTrace(host_t0=100.0, host_t1=106.0, unix_t0=9.0,
                          step0=3, step1=5,
                          ops=[("k", 10.0, 1.0), ("k", 10.5, 1.0),
                               ("copy", 13.0, 0.5)])


def _rec(spans, device=None, steps=4):
    return {"spans": spans, "span_window": (1.0, 3.0),
            "steps": [SimpleNamespace(occupancy=1)] * steps,
            "device": device}


def _read(name, rec):
    return spec.metric_reader(name).read(rec)


def test_readers_match_benchmark_entries():
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        r, m = spec.metric_reader(name), entries[name]
        assert (r.LAYER, r.UNIT, r.MOVES) == (m["layer"], m["unit"],
                                              m["moves"])
        assert "workloads" not in m


def test_idle_inside_spans_that_straddle_device_ops():
    spans = [_span("forward", 9.5, 10.5),     # idle 0.5, busy 0.5
             _span("forward", 11.0, 14.0),    # busy 0.5 + 0.5: idle 2.0
             _span("forward", 14.5, 16.0),    # ends past the window
             _span("forward", 8.0, 9.2),      # starts before it
             _span("prefill", 12.0, 12.5),    # no activity: idle 0.5
             _span("decode", 9.0, 15.0)]
    dev = _device()
    got = DC.profiled_spans(spans, dev, "forward")
    assert [(s.u0, s.u1) for s in got] == [(9.5, 10.5), (11.0, 14.0)]
    assert DC.idle_s(got, dev.ops) == pytest.approx(2.5)
    assert DC.idle_s(DC.profiled_spans(spans, dev, "decode"),
                     dev.ops) == pytest.approx(6.0 - 2.0)
    rec = _rec(spans, dev)
    # per profiled step: two of them
    assert _read("forward_idle_ms_per_step", rec) == pytest.approx(1250.0)
    assert _read("prefill_idle_ms_per_step", rec) == pytest.approx(250.0)


def test_span_wholly_inside_one_activity_is_not_idle():
    dev = _device()
    spans = [_span("forward", 10.2, 11.2), _span("forward", 11.5, 13.0)]
    assert DC.idle_s(spans[:1], dev.ops) == pytest.approx(0.0)
    assert DC.idle_s(spans[1:], dev.ops) == pytest.approx(1.5)


def test_spans_without_stamps_read_nothing():
    """A program whose spans carry no Unix stamps gives no idle reading
    (the metric falls silent, it does not raise)."""
    old = SimpleNamespace(name="forward", t0=1.0, t1=2.0, step=-1,
                          args={})
    rec = _rec([old, SimpleNamespace(name="prefill", t0=1.5, t1=1.8,
                                     step=-1, args={})], _device())
    for name in NEW:
        assert _read(name, rec) is None


def test_sample_and_readback_per_window_step():
    spans = [_span("sample", 0, 0, t0=1.5, t1=1.6, device_s=0.004),
             _span("sample", 0, 0, t0=2.0, t1=2.1, device_s=0.002),
             _span("sample", 0, 0, t0=3.5, t1=3.6, device_s=9.0),  # late
             _span("sample", 0, 0, t0=2.5, t1=2.6),   # no device time
             _span("readback", 0, 0, t0=1.7, t1=1.75),
             _span("readback", 0, 0, t0=2.2, t1=2.35),
             _span("readback", 0, 0, t0=0.5, t1=0.6)]  # before it
    rec = _rec(spans, _device(), steps=4)
    assert _read("sample_device_ms_per_step", rec) == pytest.approx(1.5)
    assert _read("readback_ms_per_step", rec) == pytest.approx(50.0)


def test_none_without_a_device_trace():
    spans = [_span("sample", 9.5, 9.6, t0=1.5, t1=1.6, device_s=0.004),
             _span("readback", 9.6, 9.7, t0=1.7, t1=1.75),
             _span("forward", 9.5, 10.5), _span("prefill", 12.0, 12.5)]
    for name in NEW:
        assert _read(name, _rec(spans, None)) is None
    # a trace with no steps profiled divides by nothing
    dev = _device()
    dev.step1 = dev.step0
    assert _read("forward_idle_ms_per_step", _rec(spans, dev)) is None
