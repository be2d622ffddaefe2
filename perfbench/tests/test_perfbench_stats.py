"""The end-to-end arithmetic and the span readers on synthetic records."""
from types import SimpleNamespace as NS

import pytest

import tiny  # noqa: F401

from benchlib import spec
from benchlib import stats as ST


def test_window_rate_counts_every_row_over_the_window():
    steps = [NS(occupancy=o) for o in (1024, 1024, 1000, 512)]
    assert ST.window_rate(steps, 10.0, 12.0) == pytest.approx(3560 / 2.0)


def test_tail_counts_tasks_still_running_at_their_age():
    done = [NS(t_done=5.0 + i, t_submit=4.0 + i) for i in range(9)]
    lat = ST.task_latencies(done, [30.0])
    assert sorted(lat)[-1] == 30.0
    # one stalled task in ten moves the p90 off the finished tasks' 1 s
    assert ST.percentile(lat, 90) > 1.0
    assert ST.percentile([1.0] * 10, 90) == 1.0


def test_percentile_interpolates():
    assert ST.percentile([1, 2, 3, 4, 5], 90) == pytest.approx(4.6)
    assert ST.percentile([3.0], 90) == 3.0


def _sp(name, t0, t1):
    return NS(name=name, t0=t0, t1=t1)


def test_decode_self_time_leaves_out_plan():
    spans = [_sp("step", 0.0, 1.0), _sp("decode", 0.1, 0.9),
             _sp("plan", 0.1, 0.3), _sp("step", 1.0, 2.0),
             _sp("decode", 1.2, 1.8), _sp("plan", 1.2, 1.25),
             _sp("admit", 1.0, 1.2), _sp("decode", 2.5, 3.0)]
    rec = {"span_window": (0.0, 2.0), "spans": spans, "steps": [1, 2]}
    dec = spec.metric_reader("decode_ms_per_step").read(rec)
    assert dec == pytest.approx(1e3 * ((0.8 - 0.2) + (0.6 - 0.05)) / 2)
    assert ST.self_time(spans, 0.0, 2.0, "decode", "plan") == \
        pytest.approx(1.15)
    plan = spec.metric_reader("plan_ms_per_step").read(rec)
    assert plan == pytest.approx(1e3 * 0.25 / 2)
    admit = spec.metric_reader("admit_ms_per_step").read(rec)
    assert admit == pytest.approx(1e3 * 0.2 / 2)


def test_readers_silent_without_a_device_trace():
    rec = {"device": None, "work": None}
    for name in ("step_mfu", "k3_roofline", "k2_roofline",
                 "device_idle_share"):
        assert spec.metric_reader(name).read(rec) is None
    assert spec.metric_reader("prefill_saved_share").read(
        {"prefix_cache": False, "admitted_prompt_tokens": 10}) is None
