#!/usr/bin/env python3
"""Time every K-split of the LUT-dequant GEMM at the served shapes on one GPU.

    python3 scripts/sweep_gemm.py [--m 8 14 17 79 133] [--n 256 1536 8960]

For each (M, N) at K = 1536 (qwen2.5-1.5b's Q4 projections) it times the
tensor-core kernel of ``lut_dequant_gemm.plan``'s regime under every split
of K (small M: wk warps x kz blocks at the plan's row tiling; large M: kz
blocks) beside ``torch.matmul`` on the pre-dequantized bf16 weight, with
``chip_smoke.time_ms``.  ``lookup_ms`` times the plan's launch on the same
shape with an nf4 codebook, which the small-M kernel dequantizes through
its shared-memory lookup instead of its packed integer path (q4_0).
Prints one JSON line per shape ({"M", "N", "plan", "ms": {"wk,kz": ms},
"best", "lookup_ms", "matmul_ms"}) and the card's name and power limit.
``plan`` picks its splits from such a sweep.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as c  # noqa: E402  (puts src/ on the path)


def main() -> int:
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import lut_dequant_gemm as G
    from repro_torch.quant import tile_quant as TQ

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, nargs="+", default=[8, 14, 17, 79, 133])
    ap.add_argument("--n", type=int, nargs="+", default=[256, 1536, 8960])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_gemm: CUDA is not available", file=sys.stderr)
        return 1
    build.build_all(("lut_dequant_gemm",))
    K = 1536
    plan = G.plan
    try:
        for M in args.m:
            for N in args.n:
                x, qw = c.gemm_case(M, K, N, torch.bfloat16, seed=1)
                ops = (x, qw["codes"], qw["scales"], qw["codebook"])
                pl = plan(M, K, N, torch.bfloat16)
                if pl.regime == "small_m":
                    max_wk = {1: 16, 2: 16}.get(pl.mt, 8)
                    splits = [(wk, kz) for wk in (1, 2, 4, 8, 16)
                              for kz in (1, 2, 4, 8)
                              if wk <= max_wk and K // 16 >= 2 * wk * kz]
                else:
                    splits = [(0, kz) for kz in (1, 2, 4, 8)]
                ms = {}
                for wk, kz in splits:
                    G.plan = lambda *a, **k: pl._replace(wk=wk, kz=kz)
                    ms[f"{wk},{kz}"] = c.time_ms(
                        lambda: G.lut_dequant_gemm(*ops))
                    G.plan = plan
                nf4 = TQ.quantize(torch.randn((K, N), device="cuda") * 0.1,
                                  codebook="nf4")
                w = TQ.dequantize(qw, dtype=torch.bfloat16)
                print(json.dumps({
                    "M": M, "N": N, "plan": pl._asdict(), "ms": ms,
                    "best": min(ms, key=ms.get),
                    "lookup_ms": c.time_ms(lambda: G.lut_dequant_gemm(
                        x, nf4["codes"], nf4["scales"], nf4["codebook"])),
                    "matmul_ms": c.time_ms(lambda: torch.matmul(x, w))}),
                    flush=True)
    finally:
        G.plan = plan
    print(c.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
