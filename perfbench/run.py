#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the card this process sees.

    python3 perfbench/run.py --workload qwen2.5-1.5b.bon16-gsm8k \\
        --seed 7 --seconds 51 --trace 0

Prints the cell's end-to-end metrics (``--trace 0``) or its per-layer
metrics from a traced window (``--trace 1``) as the last line of standard
output, one JSON object, after comparing what the timed path served with
the plain reference; the numbers compared stand beside their limits in
the last lines of standard error.  Exits non-zero, printing no result,
without a CUDA card, or if JAX or the JAX package got loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(HERE.parent / "src")]
    from benchlib import spec

    cell = spec.resolve(args.workload)
    import torch

    # the host's dispatch paces the step: one thread, no idle workers
    # competing with it for the machine's cores
    torch.set_num_threads(1)

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"this process sees {cards}", file=sys.stderr)
        return 2
    from benchlib import bench

    out = bench.run(cell, args.seed, args.seconds, bool(args.trace),
                    t_start=T_START)
    bad = bench.forbidden_modules()
    if bad:
        print(f"perfbench: the measured process loaded {bad}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
