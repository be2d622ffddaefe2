#!/usr/bin/env python3
"""The port's dry-run records beside the JAX package's, cell by cell.

    PYTHONPATH=src python -m repro.launch.dryrun --all --out runs/jax_dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out runs/dryrun
    python3 scripts/dryrun_vs_jax.py runs/jax_dryrun runs/dryrun [MORE ...] \\
        [--mesh 16x16] [--kinds all-gather all-reduce ...]

Reads the JSON records both dry-runs write (the same file names and
keys; this script imports neither package) and prints a markdown table:
per cell the per-device temp bytes and, for every collective kind either
side issues, the result bytes, in GiB, JAX's then each port directory's
with its ratio to JAX's.  Several port directories (e.g. two commits)
give one column each, in the order given; ``--kinds`` keeps those
collective kinds only.

Both are counts of a program on the CPU, not device measurements: the
JAX package's from XLA's compile for emulated host devices (its HLO
lists a loop body's collectives once, and its layers are a scan), the
port's from rank 0's program run on ``meta`` (every layer counted).
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

GIB = 2 ** 30
ARCHS = ("gemma3-1b", "stablelm-3b", "qwen2.5-14b", "command-r-35b",
         "internvl2-1b", "mamba2-130m", "olmoe-1b-7b", "mixtral-8x7b",
         "zamba2-1.2b", "whisper-base", "qwen2.5-1.5b", "llama3.2-1b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
         "collective-permute")


def load(root: Path, mesh: str) -> dict:
    """{(arch, shape): record} of the unquantized records of ``mesh``."""
    out = {}
    for p in sorted(root.glob("*.json")):
        r = json.loads(p.read_text())
        if r.get("mesh") == mesh and not r.get("quantized"):
            out[(r["arch"], r["shape"])] = r
    return out


def _gib(x) -> str:
    return f"{x / GIB:.3f}"


def _ratio(a, b) -> str:
    if b == 0:
        return "—" if a == 0 else "∞"
    return f"{a / b:.3g}×"


def _coll(rec, kind) -> float:
    return float(rec["collectives"].get(kind, {}).get("bytes", 0.0))


def table(jax: dict, ports: list, kinds=None) -> list:
    keys = sorted(set(jax) & set.intersection(*(set(p) for p in ports)),
                  key=lambda k: (ARCHS.index(k[0]) if k[0] in ARCHS
                                 else 99, SHAPES.index(k[1])))
    kinds = [k for k in (kinds or KINDS) if any(
        _coll(r, k) for d in [jax, *ports] for r in d.values())]
    n = len(ports)
    head = ["cell", "temp GiB JAX"] + [f"port{i + 1} (×JAX)" if n > 1
                                       else "port (×JAX)" for i in range(n)]
    for k in kinds:
        head += [f"{k} JAX"] + [f"port{i + 1} (×JAX)" if n > 1
                                else "port (×JAX)" for i in range(n)]
    lines = ["| " + " | ".join(head) + " |", "|" + "---|" * len(head)]
    for key in keys:
        j = jax[key]
        row = [f"{key[0]}:{key[1]}", _gib(j["per_device"]["temp_bytes"])]
        for p in ports:
            t = p[key]["per_device"]["temp_bytes"]
            row.append(f"{_gib(t)} ({_ratio(t, j['per_device']['temp_bytes'])})")
        for k in kinds:
            row.append(_gib(_coll(j, k)))
            for p in ports:
                b = _coll(p[key], k)
                row.append(f"{_gib(b)} ({_ratio(b, _coll(j, k))})")
        lines.append("| " + " | ".join(row) + " |")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("jax_dir")
    ap.add_argument("port_dirs", nargs="+")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--kinds", nargs="+", choices=KINDS, default=None)
    args = ap.parse_args(argv)
    jax = load(Path(args.jax_dir), args.mesh)
    ports = [load(Path(d), args.mesh) for d in args.port_dirs]
    print("\n".join(table(jax, ports, args.kinds)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
