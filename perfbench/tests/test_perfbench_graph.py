"""The readers of the decode forward's CUDA graph: the share of the
window's ``forward`` spans replayed from it, and the capture's host time
over the whole run, on synthetic spans."""
import json
from types import SimpleNamespace

import pytest

from tiny import ROOT

from benchlib import devtrace as DT
from benchlib import spec
from repro_torch.serving.telemetry import Span

NEW = ("forward_graph_share", "graph_capture_ms")


def _span(name, t0, t1, **args):
    return Span(name=name, t0=t0, t1=t1, args=args, u0=0.0, u1=0.0)


def _rec(spans, device=True):
    dev = DT.DeviceTrace(host_t0=100.0, host_t1=106.0, unix_t0=9.0,
                         step0=3, step1=5, ops=[]) if device else None
    return {"spans": spans, "span_window": (1.0, 3.0),
            "steps": [SimpleNamespace(occupancy=1)] * 4, "device": dev}


def _read(name, rec):
    return spec.metric_reader(name).read(rec)


def test_readers_match_benchmark_entries():
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        r, m = spec.metric_reader(name), entries[name]
        assert (r.LAYER, r.UNIT, r.MOVES) == (m["layer"], m["unit"],
                                              m["moves"])


def test_no_spans_read_nothing():
    for name in NEW:
        assert _read(name, _rec([])) is None
    # a program whose forward spans carry no graph arg (the parent)
    old = [_span("forward", 1.5, 1.6), _span("forward", 2.0, 2.1)]
    for name in NEW:
        assert _read(name, _rec(old)) is None


@pytest.mark.parametrize("flags,share", [([True, True, False, True], 75.0),
                                         ([False, False], 0.0),
                                         ([True], 100.0)])
def test_graph_share_of_window_forwards(flags, share):
    spans = [_span("forward", 1.1 + 0.4 * i, 1.3 + 0.4 * i, graph=f)
             for i, f in enumerate(flags)]
    # outside the window: the warm-up's eager step and a late replay
    spans += [_span("forward", 0.2, 0.3, graph=False),
              _span("forward", 3.5, 3.6, graph=True),
              _span("sample", 1.0, 1.1)]
    assert _read("forward_graph_share", _rec(spans)) == pytest.approx(share)
    # off the card (no device trace) the share is not read
    assert _read("forward_graph_share", _rec(spans, device=False)) is None


def test_capture_in_setup_is_counted():
    """The capture lands in the warm-up, before the window: read all the
    same, every capture summed."""
    spans = [_span("capture", 0.25, 0.5, batch=1024, width=49),
             _span("forward", 0.2, 0.6, graph=True),
             _span("forward", 1.5, 1.6, graph=True)]
    assert _read("graph_capture_ms", _rec(spans)) == pytest.approx(250.0)
    spans.append(_span("capture", 2.0, 2.125, batch=1024, width=49))
    assert _read("graph_capture_ms", _rec(spans)) == pytest.approx(375.0)
    assert _read("graph_capture_ms", _rec(spans, device=False)) == \
        pytest.approx(375.0)
