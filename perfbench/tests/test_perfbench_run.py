"""A whole run of a tiny cell on the CPU (the harness's look for a card
skipped), with the timed path sound and then broken underneath.  The
clock ticks by reads, not by time, so every run is the same."""
import pytest

from tiny import WIDE, cell, port_cfg

from benchlib import bench

SEED = 2 ** 31 + 12345


class Ticks:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


def _run(c, trace=False, faults=None, control=False, seconds=0.2):
    clock = Ticks()
    return bench.run(c, SEED, seconds, trace, device="cpu",
                     t_start=clock(), cfg=port_cfg(c.config),
                     faults=faults, control=control, clock=clock)


@pytest.mark.parametrize("header", [0, 16])
def test_sound_run_is_correct(header):
    out = _run(cell(header))
    assert out["correct"], out["checks"]
    assert out["checks"]["gap_max"]["value"] < 1e-4
    assert set(out["metrics"]) == {"decode_tok_per_s", "task_p90_s",
                                   "peak_device_gib", "setup_s"}
    assert list(out)[-1] == "checks"


def test_traced_run_reads_host_layers():
    out = _run(cell(16), trace=True)
    m = out["metrics"]
    # the device's metrics need the card's trace: silent here
    assert {"select_ms_per_task", "admit_ms_per_step", "slot_occupancy",
            "plan_ms_per_step", "decode_ms_per_step",
            "prefill_saved_share"} == set(m)
    assert 0 < m["slot_occupancy"]["value"] <= 100
    assert m["prefill_saved_share"]["value"] > 0
    assert out["correct"]


def _alter_tokens(engine):
    """A token altered where it is produced."""
    core = engine._step_core

    def step(state, *a, **k):
        st, tok = core(state, *a, **k)
        return st, (tok + 1) % engine.cfg.vocab_size

    engine._step_core = step


def _stale_state(engine):
    """A step that returns its state unchanged."""
    core = engine._step_core

    def step(state, *a, **k):
        st, tok = core(state, *a, **k)
        st.pending_logits = state.pending_logits
        return st, tok

    engine._step_core = step


def _half_batch(engine):
    """Half of the batch left out: the second half of the rows take the
    first half's logits."""
    decode = engine._decode

    def step(tok, cache, model_len, done):
        logits = decode(tok, cache, model_len, done)
        h = logits.shape[0] // 2
        logits[h:2 * h] = logits[:h]
        return logits

    engine._decode = step


@pytest.mark.parametrize("fault", [_alter_tokens, _stale_state,
                                   _half_batch])
def test_broken_path_is_not_correct(fault):
    # every finished task judged, so rows in either half of the batch are
    out = _run(cell(0, judge_tasks=1000, clients=4, n=2), faults=fault)
    assert not out["correct"], out["checks"]


def test_control_fails_where_the_program_passes():
    """The control the full-size cells use (the reference with fp8
    activations, one precision below their bf16), put in the program's
    place, comes out not correct through the cell's own comparison,
    where the program's run of the same seed is correct."""
    c = cell(0, judge_tasks=8, config=WIDE, clients=4, n=2, out=40)
    c.config["torch_dtype"] = "bfloat16"     # selects the fp8 control
    sound = _run(c, seconds=0.4)
    assert sound["correct"], sound["checks"]
    out = _run(c, control=True, seconds=0.4)
    assert not out["correct"], out["checks"]
    checks = out["checks"]
    assert checks["judged_tokens"]["value"] >= 150
    assert checks["judged_tokens"] == sound["checks"]["judged_tokens"]
    assert checks["gap_max"]["value"] > checks["gap_max"]["limit"]
    assert checks["gap_mean"]["value"] > checks["gap_mean"]["limit"]
