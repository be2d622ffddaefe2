#!/usr/bin/env python3
"""Time the port's kernels of two source trees on one GPU, interleaved.

    python3 scripts/compare_kernels.py BASE_TREE NEW_TREE [--gemm] [--flash]

Runs ``chip_smoke.py``'s kernel phase (each kernel checked against its
plain version, then timed with CUDA events) from each tree in its own
process, in the order base, new, new, base, so a drift of the card's clock
over the run falls on both sides alike.  Each tree builds its kernels into
its own ``build/``.  It also times each paged wrapper at 17 times the
decode rows (B Hkv = 272).  With ``--gemm`` it also checks and times the
LUT-dequant GEMM at the M the serve paths launch it with (8 and 14 on the
plain paths, 79 and 133 on the prefix paths).  With ``--flash`` it checks
and times, instead of the paged rows, the LUT-softmax FlashAttention (K5)
at ``chip_smoke.FLASH_CASES``' three full-width cases in each exp mode
(and, where the tree has the override, lut mode with the table forced
into shared memory and forced through the cache) and the KV dequant (K4)
at R 1792 (q8) and 12544 (q4).  Prints one JSON line per variant with the
four times and the mean new/base ratio (a variant only the new tree has:
its two times).
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
from repro_torch.kernels import ops, paged_attention as PA
# the served shapes, keyed as the tree's checks take them: a tree with
# gemm_layout keys K3 by (M, K, N) and K4 by (mode, R, Hkv, D), an older
# one by M and by (mode, R) at qwen2.5-1.5b's (K, N) and (Hkv, D)
kv_r = {{("q8", 1792): "q8/prefix", ("q4", 12544): "q4/prefix"}}
gemm = {{8: "q8/exact", 14: "q8/exact", 79: "q8/prefix", 133: "q4/prefix"}}
if hasattr(c, "gemm_layout"):
    kv_r = {{(m, r, 2, 128): p for (m, r), p in kv_r.items()}}
    gemm = {{(m, k, n): p for m, p in gemm.items()
            for k, n in ((1536, 1536), (1536, 256), (1536, 8960))}}
if {flash!r}:
    from repro_torch.kernels import lut_softmax_attention as LA
    from repro_torch.kernels.autotune import pick_block
    lut = ops.exp_lut("cuda")
    variants = [(m, None) for m in c.FLASH_MODES]
    if hasattr(LA, "_LUT_IN_SHARED"):
        variants += [("lut", True), ("lut", False)]
    for case in c.FLASH_CASES:
        if not case["timed"]:
            continue
        q, k, v = (c.heads_first(x) for x in c.flash_inputs(case))
        kw = dict(causal=case["causal"], bkv=pick_block(case["Skv"], 128),
                  kv_group=case["Hq"] // case["Hkv"])
        for mode, shared in variants:
            if shared is not None:
                LA._LUT_IN_SHARED = shared
            run = lambda: LA.lut_softmax_attention(q, k, v, lut,
                                                   exp_mode=mode, **kw)
            side = {{None: "", True: "_shared", False: "_global"}}[shared]
            name = f"lut_softmax_attention/{{mode}}{{side}}/{{case['name']}}"
            c.check_close(name, run(), LA.plain_lut_softmax_attention(
                q, k, v, lut, exp_mode=mode, **kw), 2e-3)
            rows.append({{"name": name, "ms": c.time_ms(run)}})
            if shared is not None:
                LA._LUT_IN_SHARED = None
    c.check_dequant_kv_kernel(rows, kv_r)
else:
    c.check_paged_kernels(rows)
# each paged wrapper at 17 times the decode rows (B Hkv = 272), timed only
for kind in (() if {flash!r} else ("fp", "q8", "q4")):
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
    c.check_gemm_kernel(rows, gemm)
print("ROWS " + json.dumps({{r["name"]: r["ms"] for r in rows}}))
"""


def run(tree: Path, gemm: bool, flash: bool) -> dict:
    out = subprocess.run(
        [sys.executable, "-c",
         PHASE.format(root=str(tree), gemm=gemm, flash=flash)],
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
    ap.add_argument("--flash", action="store_true",
                    help="time K5 (three full-width cases x exp modes) and "
                         "K4 (R 1792 q8, R 12544 q4) instead of the paged "
                         "rows")
    args = ap.parse_args()
    trees = [args.base, args.new, args.new, args.base]
    times = [run(t.resolve(), args.gemm, args.flash) for t in trees]
    for name in times[1]:
        n1, n2 = times[1][name], times[2][name]
        if name not in times[0]:
            print(json.dumps({"name": name, "new_ms": [n1, n2]}))
            continue
        b1, b2 = times[0][name], times[3][name]
        print(json.dumps({"name": name, "base_ms": [b1, b2],
                          "new_ms": [n1, n2],
                          "new_over_base": (n1 + n2) / (b1 + b2)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
