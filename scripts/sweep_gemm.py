#!/usr/bin/env python3
"""Time every K-split of the LUT-dequant GEMM at the served shapes on one GPU.

    python3 scripts/sweep_gemm.py [--m 8 14 17 79 133] [--k 1536]
                                  [--n 256 1536 8960] [--record]

For each (M, K, N) (default K 1536: qwen2.5-1.5b's Q4 projections) it
times every launch of ``autotune.gemm_candidates`` (small M: wk warps x
kz blocks at the plan's row tiling; large M: kz blocks) through
``lut_dequant_gemm._launch``, beside ``torch.matmul`` on the
pre-dequantized bf16 weight, with ``chip_smoke.time_ms`` (hot: one
weight back to back).  ``lookup_ms`` times the analytic plan's launch on
the same shape with an nf4 codebook, which the small-M kernel
dequantizes through its shared-memory lookup instead of its packed
integer path (q4_0).  Prints one JSON line per shape ({"M", "K", "N",
"plan", "ms": {"wk,kz": ms}, "best", "lookup_ms", "matmul_ms"}) and the
card's name and power limit.  ``lut_dequant_gemm.plan`` picks its splits
from such a sweep; ``--record`` writes each shape's fastest launch
through ``autotune.record`` into ``autotune.cache_path()``
(``runs/autotune.json`` unless ``REPRO_AUTOTUNE_CACHE`` says otherwise),
where the wrapper then launches it on this card.
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

    from repro_torch.kernels import autotune as AT
    from repro_torch.kernels import build
    from repro_torch.kernels import lut_dequant_gemm as G
    from repro_torch.quant import tile_quant as TQ

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, nargs="+", default=[8, 14, 17, 79, 133])
    ap.add_argument("--k", type=int, nargs="+", default=[1536])
    ap.add_argument("--n", type=int, nargs="+", default=[256, 1536, 8960])
    ap.add_argument("--record", action="store_true",
                    help="record each shape's fastest launch in the "
                         "autotune cache")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_gemm: CUDA is not available", file=sys.stderr)
        return 1
    build.build_all(("lut_dequant_gemm",))
    bf16 = torch.bfloat16
    for K in args.k:
        for M in args.m:
            for N in args.n:
                x, qw = c.gemm_case(M, K, N, bf16, seed=1)
                ops = (x, qw["codes"], qw["scales"], qw["codebook"])
                out = torch.empty((M, N), dtype=bf16, device="cuda")
                pl = G.plan(M, K, N, bf16)
                cands = AT.gemm_candidates(M, K, N, bf16)
                ms = {blocks: c.time_ms(lambda p=p: G._launch(*ops, out, p))
                      for blocks, p in cands.items()}
                best = min(ms, key=ms.get)
                if args.record:
                    AT.record(AT.gemm_key(M, K, N, bf16), best,
                              ms[best] * 1e3)
                nf4 = TQ.quantize(torch.randn((K, N), device="cuda") * 0.1,
                                  codebook="nf4")
                w = TQ.dequantize(qw, dtype=bf16)
                name = {b: f"{p.wk},{p.kz}" for b, p in cands.items()}
                print(json.dumps({
                    "M": M, "K": K, "N": N, "plan": pl._asdict(),
                    "ms": {name[b]: t for b, t in ms.items()},
                    "best": name[best],
                    "lookup_ms": c.time_ms(lambda: G._launch(
                        x, nf4["codes"], nf4["scales"], nf4["codebook"],
                        out, pl)),
                    "matmul_ms": c.time_ms(lambda: torch.matmul(x, w))}),
                    flush=True)
    if args.record:
        print(f"recorded in {AT.cache_path()}", flush=True)
    print(c.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
