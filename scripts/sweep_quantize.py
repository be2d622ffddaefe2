#!/usr/bin/env python3
"""Time the tile-quantize kernel (K6) with either load, in turns, on one GPU.

    python3 scripts/sweep_quantize.py [--n 256 1536 8960] [--dtype float32]
                                      [--rounds 8]

For each (K, N) at K = 1536 (qwen2.5-1.5b's Q4 projections: N 256, 1536
and 8960 are its k/v, q/o and gate/up widths) it checks both loads
bit-equal to the plain version, then times them with
``chip_smoke.time_ms`` in ``--rounds`` rounds of narrow, wide, wide,
narrow, and an empty kernel on the same grid.  Prints one JSON line per
shape ({"K", "N", "dtype", "ms": {"narrow": [...], "wide": [...]},
"median": {...}, "empty_ms", "bound_ms", "bound_by"}) and the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as c  # noqa: E402  (puts src/ on the path)


def main() -> int:
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import tile_quantize as TK

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, nargs="+", default=[256, 1536, 8960])
    ap.add_argument("--dtype", nargs="+", default=["float32"])
    ap.add_argument("--rounds", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_quantize: CUDA is not available", file=sys.stderr)
        return 1
    build.build_all(("tile_quantize",))
    K = 1536
    for name in args.dtype:
        dtype = getattr(torch, name)
        for N in args.n:
            gen = torch.Generator(device="cuda").manual_seed(N)
            w = (torch.randn((K, N), generator=gen, device="cuda")
                 / K ** 0.5).to(dtype)
            codes, scales = TK.plain_tile_quantize(w)
            for wide in (False, True):
                got = TK._launch(w, wide)
                torch.cuda.synchronize()
                if not (torch.equal(got[0], codes)
                        and torch.equal(got[1], scales)):
                    raise AssertionError(
                        f"K{K} N{N} {name} wide {wide}: not bit-identical "
                        f"to the plain version")
            ms = {"narrow": [], "wide": []}
            for _ in range(args.rounds):
                for kind in ("narrow", "wide", "wide", "narrow"):
                    ms[kind].append(c.time_ms(lambda: TK._launch(
                        w, kind == "wide")))
            # weight in; codes (K, N / 2) and fp16 scales (K / 2, N / 16) out
            nbytes = K * N * w.element_size() + K * N // 2 + K * N // 16
            b_ms, b_by = c.bound(nbytes, 4.0 * K * N, "float32")
            print(json.dumps({
                "K": K, "N": N, "dtype": name, "ms": ms,
                "median": {k: statistics.median(v) for k, v in ms.items()},
                "empty_ms": c.time_ms(lambda: TK.empty_launch(w)),
                "bound_ms": b_ms, "bound_by": b_by}), flush=True)
    print(c.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
