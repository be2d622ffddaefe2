#!/usr/bin/env python3
"""Static SASS instruction counts of the port's CUDA kernels, by opcode.

    python3 scripts/sass_counts.py lut_softmax_attention [lut_dequant_kv ...]

Compiles ``src/repro_torch/kernels/csrc/<name>.cu`` with the flags of
``kernels/build.py`` into a cubin under ``build/sass/``, disassembles it
with ``cuobjdump -sass`` and prints one JSON line per kernel instantiation:
its total instruction count and the count of each opcode class (tensor-core
HMMA, ldmatrix, shared and global loads and stores, MUFU, f32 and packed
f16 arithmetic, conversions, shuffles, barriers, the rest), and the same
counts for its main loop: the backward branch whose body holds the most
HMMA (or, without HMMA, the most instructions).  K5's loop over the KV
blocks is fully unrolled inside and not across blocks, so its loop count
is one KV block's work for a warp, all k steps taken.  Needs the CUDA
toolkit (``nvcc``, ``cuobjdump``); ``ncu`` is not needed.
"""
from __future__ import annotations

import collections
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build  # noqa: E402

CLASSES = {
    "tensor": ("HMMA",), "ldmatrix": ("LDSM",),
    "shared": ("LDS", "STS", "LDGSTS"), "global": ("LDG", "STG"),
    "mufu": ("MUFU",),
    "f32": ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL"),
    "f16x2": ("HADD2", "HMUL2", "HFMA2", "HMNMX2", "HSETP2"),
    "convert": ("F2F", "F2FP", "F2I", "I2F", "I2FP", "FRND"),
    "shuffle": ("SHFL",), "barrier": ("BAR",),
}
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)")
_BRA = re.compile(r"BRA[^;]*?(0x[0-9a-f]+)")


def _tool(name: str) -> str:
    nvcc = Path(build._nvcc())
    found = shutil.which(name) or str(nvcc.parent / name)
    if not Path(found).exists():
        raise RuntimeError(f"{name} not found beside {nvcc}")
    return found


def counts(name: str) -> list[dict]:
    out_dir = build.BUILD_DIR.parent / "sass"
    out_dir.mkdir(parents=True, exist_ok=True)
    cubin = out_dir / f"{name}.cubin"
    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                      "-fPIC")]
    subprocess.run([build._nvcc(), *flags, "-cubin", "-o", str(cubin),
                    str(build.CSRC / f"{name}.cu")], check=True)
    sass = subprocess.run([_tool("cuobjdump"), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    rows, fn, insns = [], None, []
    for line in sass.splitlines() + ["Function : <end>"]:
        if "Function :" in line:
            if fn is not None:
                rows.append((fn, insns))
            fn, insns = line.split("Function :", 1)[1].strip(), []
            continue
        m = _INSN.search(line)
        if m and fn is not None:
            b = _BRA.search(line)
            insns.append((int(m.group(1), 16), m.group(2).split(".")[0],
                          int(b.group(1), 16) if b else None))
    return [{"source": name, "kernel": fn, **_classes(insns),
             "loop": _classes(_main_loop(insns))} for fn, insns in rows]


def _classes(insns) -> dict:
    ops = collections.Counter(op for _, op, _ in insns)
    by_class = {c: sum(ops[o] for o in names) for c, names in CLASSES.items()}
    by_class["other"] = sum(ops.values()) - sum(by_class.values())
    return {"total": sum(ops.values()), **by_class}


def _main_loop(insns):
    best, key = [], (0, 0)
    for addr, op, target in insns:
        if op == "BRA" and target is not None and target < addr:
            body = [i for i in insns if target <= i[0] <= addr]
            k = (sum(o == "HMMA" for _, o, _ in body), len(body))
            if k > key:
                best, key = body, k
    return best


def main() -> int:
    for name in sys.argv[1:] or build.SOURCES:
        for row in counts(name):
            print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
