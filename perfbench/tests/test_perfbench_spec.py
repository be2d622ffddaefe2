"""The harness finds a cell's files by the names in BENCHMARK.json, so a
configuration, a mix, a cell or a metric is added as new files."""
import json
import shutil
from pathlib import Path

import tiny  # noqa: F401

from benchlib import spec

ROOT = Path(__file__).resolve().parents[1]


def test_every_cell_and_metric_resolves():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        cell = spec.resolve(w["name"])
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert cell.per_layer
        assert cell.traffic["generator"] == "closed_best_of_n"
        assert cell.config["reduced"] == next(
            c["reduced"] for c in bench["configs"]
            if c["name"] == w["config"])
        spec.reference_module(cell.config["reference"])
    for m in bench["per_layer"]:
        r = spec.metric_reader(m["name"])
        assert (r.LAYER, r.UNIT, r.MOVES) == (m["layer"], m["unit"],
                                              m["moves"]), m["name"]


def test_new_files_are_found(tmp_path):
    root = tmp_path / "perfbench"
    shutil.copytree(ROOT, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "configs" / "qwen2.5-1.5b-w4a16.json")
                     .read_text())
    cfg["name"] = "other-model"
    (root / "configs" / "other-model.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "traffic" / "bon4-fewshot.json").read_text())
    mix["clients"] = 32
    (root / "traffic" / "bon4-other.json").write_text(json.dumps(mix))
    (root / "limits" / "other-model.bon4-other.json").write_text(
        json.dumps({"judge_tasks": 4, "judged_tokens_min": 100,
                    "gap_max": {"limit": 1.0}, "gap_mean": {"limit": 1.0}}))
    (root / "metrics" / "steps_in_window.py").write_text(
        'LAYER = "scheduler"\nUNIT = "steps"\nMOVES = "decode_tok_per_s"'
        '\n\n\ndef read(rec):\n    return len(rec["steps"]) or None\n')
    bench["configs"].append({"name": "other-model", "source": "x",
                             "file": "perfbench/configs/other-model.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "other-model.bon4-other",
                               "config": "other-model",
                               "traffic": "bon4-other", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "steps_in_window", "unit": "steps",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "scheduler",
                               "moves": "decode_tok_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.resolve("other-model.bon4-other", root)
    assert cell.traffic["clients"] == 32
    assert cell.config["name"] == "other-model"
    assert cell.limits["judge_tasks"] == 4
    names = [m["name"] for m in cell.per_layer]
    assert "steps_in_window" in names and "prefill_saved_share" not in names
    reader = spec.metric_reader("steps_in_window", root)
    assert reader.read({"steps": [1, 2, 3]}) == 3
    # the cells already there still resolve in the copy
    assert spec.resolve("qwen2.5-1.5b.bon4-fewshot", root).per_layer
