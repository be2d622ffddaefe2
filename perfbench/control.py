#!/usr/bin/env python3
"""The control of a cell's comparison, read on the card: the cell's run
at its own load, then the reference one precision below the
configuration's (``reference.BELOW``) put in the program's place, its
first choices judged through the cell's own comparison.  One process for
every seed; one JSON line per seed with ``correct`` and the numbers
compared beside their limits.  Exits 1 if the control comes out correct
on any seed.

    python3 perfbench/control.py --workload qwen2.5-1.5b.bon16-gsm8k \\
        --seeds 11,12,13 --seconds 51

The benchmark's own runs never run it.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(HERE.parent / "src")]
    import torch

    from benchlib import bench, spec

    cell = spec.resolve(args.workload)
    passed = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        torch.cuda.reset_peak_memory_stats()
        out = bench.run(cell, seed, args.seconds, False,
                        t_start=time.perf_counter(), control=True)
        print(json.dumps({"seed": seed, "correct": out["correct"],
                          "checks": out["checks"],
                          "metrics": out["metrics"]}), flush=True)
        if out["correct"]:
            passed.append(seed)
    if passed:
        print(f"control: came out correct on seeds {passed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
