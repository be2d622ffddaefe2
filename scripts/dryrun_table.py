#!/usr/bin/env python3
"""A markdown table of dry-run records.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out runs/dryrun
    python3 scripts/dryrun_table.py runs/dryrun [MESH_TAG]

One row per record file (``<arch>__<shape>__<mesh>[__q4].json``, the
dry-run's output) whose mesh tag is MESH_TAG (default 16x16), in
registry order: per-device FLOPs, bytes accessed, argument and temp
bytes (GiB), and collective result bytes by primitive (GiB) with their
counts.  These are counts of the port's program on ``meta``, not
measurements of a device.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

GIB = 2 ** 30
KINDS = ("all-gather", "reduce-scatter", "all-reduce", "collective-permute")


def main(argv) -> int:
    root = Path(argv[1])
    tag = argv[2] if len(argv) > 2 else "16x16"
    recs = [json.loads(p.read_text()) for p in sorted(root.glob("*.json"))]
    recs = [r for r in recs if r["mesh"] == tag]
    order = {a: i for i, a in enumerate(
        ("gemma3-1b", "stablelm-3b", "qwen2.5-14b", "command-r-35b",
         "internvl2-1b", "mamba2-130m", "olmoe-1b-7b", "mixtral-8x7b",
         "zamba2-1.2b", "whisper-base", "qwen2.5-1.5b", "llama3.2-1b"))}
    shapes = {s: i for i, s in enumerate(
        ("train_4k", "prefill_32k", "decode_32k", "long_500k"))}
    recs.sort(key=lambda r: (order.get(r["arch"], 99), shapes[r["shape"]],
                             r["quantized"]))
    print("| cell | FLOPs | bytes | args GiB | temp GiB | "
          + " | ".join(f"{k} GiB (n)" for k in KINDS) + " |")
    print("|" + "---|" * (5 + len(KINDS)))
    for r in recs:
        pd, co = r["per_device"], r["collectives"]
        cells = [f"{r['arch']}:{r['shape']}" + (" q4" if r["quantized"]
                                               else ""),
                 f"{pd['flops']:.3e}", f"{pd['bytes_accessed']:.3e}",
                 f"{pd['argument_bytes'] / GIB:.3f}",
                 f"{pd['temp_bytes'] / GIB:.1f}"]
        for k in KINDS:
            d = co.get(k)
            cells.append(f"{d['bytes'] / GIB:.3f} ({d['count']})" if d
                         else "—")
        print("| " + " | ".join(cells) + " |")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
