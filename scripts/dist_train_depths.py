#!/usr/bin/env python3
"""Time ``launch/train.py --mesh 2x2`` at several depths on one GPU.

    python3 scripts/dist_train_depths.py 8 4

Four ranks share the card over ``gloo`` (``torch.distributed.run``), as
``chip_smoke.py``'s ``dist`` phase runs them: qwen2.5-1.5b at its
published widths, 3 steps of 8 x 128, a checkpoint at the end.  For each
depth prints the launch's wall seconds, the steps' losses and seconds,
the checkpoint's save time and each rank's peak device bytes.  The
collectives go through the host, so the times bound that phase's budget
and say nothing about NVLink or NCCL.
"""
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main(depths) -> int:
    print(chip_smoke.nvidia_smi(), flush=True)
    for layers in depths:
        ckpt = ROOT / "build" / f"ck_depth{layers}"
        t0 = time.perf_counter()
        try:
            out = chip_smoke._torchrun(
                4, ["-m", "repro_torch.launch.train", "--mesh",
                    chip_smoke.DIST_MESH, "--backend", "gloo", "--ckpt-dir",
                    str(ckpt)]
                + chip_smoke.DIST_TRAIN_ARGS + ["--n-layers", str(layers)])
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        print(f"layers {layers} wall_s {time.perf_counter() - t0}",
              flush=True)
        print("\n".join(line for line in out.splitlines()
                        if line.startswith(("step", "[train]", "[ft]"))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["8", "4"]))
