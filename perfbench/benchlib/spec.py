"""Find everything a cell needs by the names in ``BENCHMARK.json``.

A cell names a configuration and a traffic mix; the configuration entry
names its file.  Everything else is found by name beside them:

- ``traffic/<traffic>.json``: the mix's parameters (one general generator,
  ``benchlib/traffic.py``, reads every mix);
- ``limits/<workload>.json``: the limits of the numbers that decide
  ``correct`` in that cell, and the readings they were set from;
- ``metrics/<metric>.py``: one reader per per-layer metric;
- ``families/<reference>.py``: the model family the configuration file's
  ``reference`` key names: its dimensions, its seeded weights, the
  port's configuration and the model's cost rules
  (``families/transformer.py`` lists what a family gives);
- ``reference/<reference>.py``: the plain reference of that family.

So a later change adds a configuration, of a family already here or of a
new one, a mix, a cell or a metric by adding files and entries, and
edits none.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parents[1]   # the perfbench directory


@dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration file's content
    traffic: dict           # the traffic file's content
    limits: dict            # the limits file's content
    end_to_end: list        # BENCHMARK.json entries reported by this cell
    per_layer: list
    family: ModuleType      # families/<reference>.py
    root: Path = field(default=ROOT)


def load_benchmark(root: Path = ROOT) -> dict:
    path = root.parent / "BENCHMARK.json"
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def resolve(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` with every file it
    needs read.  Raises when a file is missing."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    centry = configs[w["config"]]
    config = json.loads((root.parent / centry["file"]).read_text())
    config["reduced"] = list(centry.get("reduced", []))
    traffic = json.loads((root / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((root / "limits" / f"{workload}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in reported and _applies(m, workload)]
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=per_layer,
                family=family_module(config["reference"], root), root=root)


def _load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT):
    """The module ``metrics/<name>.py``: its ``read(rec)`` returns the
    metric's value, or None where the run holds nothing to read."""
    return _load_file(root / "metrics" / f"{name}.py",
                      f"perfbench_metric_{name.replace('.', '_')}")


def reference_module(family: str, root: Path = ROOT):
    """The plain reference ``reference/<family>.py``."""
    return _load_file(root / "reference" / f"{family}.py",
                      f"perfbench_reference_{family}")


def family_module(family: str, root: Path = ROOT):
    """The model family ``families/<family>.py``."""
    return _load_file(root / "families" / f"{family}.py",
                      f"perfbench_family_{family.replace('.', '_')}")
