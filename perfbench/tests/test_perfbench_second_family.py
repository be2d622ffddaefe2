"""A configuration of a new model family needs only added files: a
perfbench root with the harness's ``benchlib/`` and ``metrics/`` copied
untouched, and beside them a family, a reference, a configuration, a
traffic mix, a limits file and a ``BENCHMARK.json`` of its own.  The
family (``windowed_family.py``) slides a window over three layers in
four, shorter than the traffic's contexts, and draws its weights a layer
at a time."""
import filecmp
import json
import shutil
import weakref
from pathlib import Path

import pytest

from tiny import CONFIG

from benchlib import bench, spec
from benchlib import yardstick as Y
from benchlib.devtrace import DeviceTrace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SEED = 2 ** 31 + 4242
WINDOW = 4
CELL = "tiny-window.short"
WINDOWED = dict(CONFIG, name="tiny-window", num_hidden_layers=4,
                sliding_window=WINDOW, reference="windowed",
                layer_types=["sliding_attention"] * 3 + ["full_attention"])


class Ticks:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1e-3
        return self.t


def _mix(header: int) -> dict:
    # every prompt is longer than the window
    return {"generator": "closed_best_of_n", "clients": 2, "n_samples": 3,
            "prompt": {"median": 12, "sigma": 0.5, "min": 6, "max": 20},
            "output": {"median": 10, "sigma": 0.5, "min": 4, "max": 16},
            "header_tokens": header, "temperature": 0.8,
            "prefix_cache": bool(header)}


def _root(tmp_path: Path, header: int) -> Path:
    """A perfbench root: the harness copied, the new family added."""
    root = tmp_path / "perfbench"
    for sub in ("benchlib", "metrics"):
        shutil.copytree(ROOT / sub, root / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for sub in ("families", "reference", "configs", "traffic", "limits"):
        (root / sub).mkdir()
    shutil.copy(HERE / "windowed_family.py", root / "families" / "windowed.py")
    shutil.copy(ROOT / "reference" / "transformer.py",
                root / "reference" / "windowed.py")
    (root / "configs" / "tiny-window.json").write_text(json.dumps(WINDOWED))
    (root / "traffic" / "short.json").write_text(json.dumps(_mix(header)))
    (root / "limits" / f"{CELL}.json").write_text(json.dumps(
        {"judge_tasks": 3, "judged_tokens_min": 10,
         "gap_max": {"limit": 1e-3}, "gap_mean": {"limit": 1e-5}}))
    bench_json = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    bench_json["configs"] = [{"name": "tiny-window", "source": "x",
                              "file": "perfbench/configs/tiny-window.json",
                              "reduced": [], "why": "x"}]
    bench_json["workloads"] = [{"name": CELL, "config": "tiny-window",
                                "traffic": "short", "chips": 1, "why": "x"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench_json))
    return root


def _unchanged(root: Path) -> None:
    for sub in ("benchlib", "metrics"):
        cmp = filecmp.dircmp(ROOT / sub, root / sub,
                             ignore=["__pycache__"])
        assert not (cmp.diff_files or cmp.left_only or cmp.right_only), sub


class Layer(dict):
    """A layer's f32 dict that a weak reference can watch."""


def _matrices(node):
    for k, v in node.items():
        if isinstance(v, dict):
            yield from _matrices(v)
        elif k == "w":
            yield v


def _watched(make, held: list):
    """``make`` whose layers are watched: before each draw, ``held``
    gets the number of earlier layers' dicts and weight matrices still
    alive."""

    def layers(it):
        refs = []
        while True:
            held.append(sum(r() is not None for r in refs))
            try:
                box = [Layer(next(it))]
            except StopIteration:
                return
            refs += [weakref.ref(box[0])]
            refs += [weakref.ref(w) for w in _matrices(box[0])]
            yield box.pop()       # no name here keeps the layer

    def make_weights(dims, seed, device):
        top, it = make(dims, seed, device)
        return top, layers(iter(it))

    return make_weights


def _run(cell, trace=False):
    clock = Ticks()
    return bench.run(cell, SEED, 0.2, trace, device="cpu", t_start=clock(),
                     clock=clock)


@pytest.mark.parametrize("header", [0, 16])
def test_a_new_family_runs_correct_from_added_files(tmp_path, monkeypatch,
                                                    header):
    root = _root(tmp_path, header)
    cell = spec.resolve(CELL, root)
    assert cell.family.dims(cell.config)["windows"] == [WINDOW] * 3 + [0]
    held = []
    monkeypatch.setattr(cell.family, "make_weights",
                        _watched(cell.family.make_weights, held))
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["checks"]["gap_max"]["value"] < 1e-4
    # build and the reference each drew 4 layers, holding one at a time
    assert held == [0] * 10
    _unchanged(root)
    assert not (ROOT / "families" / "windowed.py").exists()


def test_the_window_is_judged(tmp_path, monkeypatch):
    """The served path's windows matter: a reference that ignores them
    judges the same run not correct."""
    cell = spec.resolve(CELL, _root(tmp_path, 0))
    load = spec.reference_module

    def blind(name, root):
        ref = load(name, root)
        logits = ref.sequence_logits

        def full(w, model, *a, **k):
            return logits(w, dict(model, windows=None), *a, **k)

        ref.sequence_logits = full
        return ref

    monkeypatch.setattr(spec, "reference_module", blind)
    out = _run(cell)
    assert not out["correct"], out["checks"]


def test_the_readers_use_the_familys_rules(tmp_path):
    cell = spec.resolve(CELL, _root(tmp_path, 0))
    F, m = cell.family, cell.family.dims(cell.config)
    assert F.k2_keys(m, 40) == 3 * WINDOW + 40
    assert F.k2_keys(m, 3) == 4 * 3
    assert F.attn_flops(m, 40) == 4.0 * 4 * 16 * (3 * WINDOW + 40)
    steps = [[3, 9, 30], [4, 10, 31, 2]]
    ops = [("void paged_attention_kernel<16>(float*)", 0.0, 1e-5)] * 8
    rec = {"model": m, "family": F, "n_slots": 4, "block_size": 16,
           "max_len": 48, "k2_symbols": bench.K2_SYMBOLS,
           "work": {"contexts": steps, "prefills": [(20, 0), (24, 16)]},
           "device": DeviceTrace(host_t0=0.0, host_t1=2.0, ops=ops,
                                 k2_launches=4 * len(steps))}
    # each launch by hand: one per layer, over its own window's keys
    least = sum(Y.least_s(*Y.paged_attn_cost(
        4, 4, 3, 16, 16, slab_bytes=Y.q8_slab_bytes(2, 16),
        tokens=sum(min(c, w) if w else c for c in ctx)))
        for ctx in steps for w in m["windows"])
    k2 = spec.metric_reader("k2_roofline", cell.root).read(rec)
    assert k2 == pytest.approx(100.0 * least / 8e-5, rel=1e-12)
    attn = 4.0 * 4 * 16 * (
        sum(F.k2_keys(m, c) for ctx in steps for c in ctx)
        + sum(F.k2_keys(m, q) for q in range(1, 21))
        + sum(F.k2_keys(m, q) for q in range(17, 25)))
    flops = (7 + 20 + 8) * F.token_flops(m) + 9 * F.head_flops(m) + attn
    mfu = spec.metric_reader("step_mfu", cell.root).read(rec)
    assert mfu == pytest.approx(100.0 * flops / (2.0 * Y.PEAK_BF16_FLOPS),
                                rel=1e-12)
