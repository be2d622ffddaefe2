#!/usr/bin/env python3
"""Time the port's kernels of two source trees on one GPU, interleaved.

    python3 scripts/compare_kernels.py BASE_TREE NEW_TREE [--gemm]

Runs ``chip_smoke.py``'s kernel phase (each kernel checked against its
plain version, then timed with CUDA events) from each tree in its own
process, in the order base, new, new, base, so a drift of the card's clock
over the run falls on both sides alike.  Each tree builds its kernels into
its own ``build/``.  It also times each paged wrapper at 17 times the
decode rows (B Hkv = 272).  With ``--gemm`` it also checks and times the
LUT-dequant GEMM at the M the serve paths launch it with (8 and 14 on the
plain paths, 79 and 133 on the prefix paths).  Prints one JSON line per
variant with the four times and the mean new/base ratio.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

PHASE = """
import json, sys
sys.path.insert(0, {root!r})
import chip_smoke as c
import torch
torch.backends.cuda.matmul.allow_tf32 = False
from repro_torch.kernels import build
build.build_all()
rows = []
c.check_paged_kernels(rows)
# each paged wrapper at 17 times the decode rows (B Hkv = 272), timed only
from repro_torch.kernels import ops, paged_attention as PA
for kind in ("fp", "q8", "q4"):
    wr = PA.paged_attention if kind == "fp" else PA.quant_paged_attention
    q, kp, vp, table, lens = c.paged_case(kind, torch.bfloat16, seed=7)
    big = (q.repeat(17, 1, 1, 1), kp, vp, table.repeat(17, 1), lens.repeat(17))
    extra = () if kind == "fp" else (ops.q4_codebook(q.device),)
    for mode in ("exact", "lut"):
        lut = ops.exp_lut(q.device) if mode == "lut" else None
        rows.append({{"name": f"{{wr.__name__}}/{{kind}}/{{mode}}/B136",
                     "ms": c.time_ms(lambda: wr(*big, lut, *extra,
                                                exp_mode=mode))}})
if {gemm!r}:
    c.check_gemm_kernel(rows, {{8: "q8/exact", 14: "q8/exact",
                               79: "q8/prefix", 133: "q4/prefix"}})
print("ROWS " + json.dumps({{r["name"]: r["ms"] for r in rows}}))
"""


def run(tree: Path, gemm: bool) -> dict:
    out = subprocess.run(
        [sys.executable, "-c", PHASE.format(root=str(tree), gemm=gemm)],
        cwd=tree, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{tree}: exit {out.returncode}\n{out.stderr}")
    line = next(l for l in out.stdout.splitlines() if l.startswith("ROWS "))
    return json.loads(line[5:])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("base", type=Path)
    ap.add_argument("new", type=Path)
    ap.add_argument("--gemm", action="store_true",
                    help="also time the LUT-dequant GEMM at M = 8, 14, 79 "
                         "and 133")
    args = ap.parse_args()
    trees = [args.base, args.new, args.new, args.base]
    times = [run(t.resolve(), args.gemm) for t in trees]
    for name in times[0]:
        b1, n1, n2, b2 = (t[name] for t in times)
        print(json.dumps({"name": name, "base_ms": [b1, b2],
                          "new_ms": [n1, n2],
                          "new_over_base": (n1 + n2) / (b1 + b2)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
