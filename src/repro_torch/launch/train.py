"""Training entry point of the port, on one device (CUDA unless asked
otherwise).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-1.5b \\
      --steps 100 --batch 8 --seq 128 --ckpt-dir runs/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --smoke --device cpu --steps 6 --batch 4 --seq 64

Random seeded init (seed 0) in ``cfg.param_dtype``, AdamW with 20 warmup
steps over ``--steps``, batches of the synthetic math tasks.  With
``--ckpt-dir`` the state {"params", "opt", "step"} is saved every
``--ckpt-every`` steps (asynchronously), on SIGTERM/SIGINT and at the
end, and relaunching the identical command resumes from the latest
save.  ``--mesh`` (data x model sharding) comes with the port's
distributed layer.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.data.dataset import MathDataLoader
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import (PreemptionHandler,
                                                     StragglerMonitor,
                                                     resume_or_init)
from repro_torch.models import api
from repro_torch.train.loop import make_train_step, to_batch
from repro_torch.train.optimizer import AdamWConfig, init_opt_state


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="", help="e.g. 2x1: data x model")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    if args.mesh:
        raise SystemExit("--mesh needs the port's distributed layer "
                         "(sharding, mesh), which a later slice ports; "
                         "this entry point trains on one device")
    return args


def main(argv=None) -> dict:
    """Train and print the JAX entry point's lines.  Returns {"start":
    the step it resumed at, "losses", "grad_norms": per step run, "step_s":
    each step's seconds (ended by a device sync), "state": the final
    {"params", "opt", "step"}, "cfg"}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    tok = ByteTokenizer(vocab_size=max(320, cfg.vocab_size))
    if cfg.vocab_size < tok.vocab_size:
        cfg = cfg.with_(vocab_size=tok.vocab_size)
    model = api.get_model(cfg)
    oc = AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps)
    step_fn = make_train_step(cfg, oc, microbatches=args.microbatches)

    def init():
        p = model.init_params(cfg, seed=0, device=device)
        return {"params": p, "opt": init_opt_state(p),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt is not None:
        abstract = api.abstract_params(cfg)
        template = {"params": abstract, "opt": init_opt_state(abstract),
                    "step": torch.zeros((), dtype=torch.int32,
                                        device="meta")}
        state, _ = resume_or_init(ckpt, template, init,
                                  log_fn=lambda m: print(m, flush=True),
                                  device=device)
    else:
        state = init()
    start = int(state["step"])

    loader = MathDataLoader(tok, batch_size=args.batch, seq_len=args.seq,
                            host_id=0, n_hosts=1)
    monitor = StragglerMonitor()

    def emergency_save():
        if ckpt is not None:
            print("[ft] preemption: emergency checkpoint")
            ckpt.save(state, step=int(state["step"]))

    out = {"start": start, "losses": [], "grad_norms": [], "step_s": []}
    with PreemptionHandler(emergency_save) as ph:
        t0 = time.time()
        for i in range(start, args.steps):
            batch = to_batch(next(loader), device)
            ts = time.perf_counter()
            p, o, metrics = step_fn(state["params"], state["opt"], batch)
            loss = float(metrics["loss"])  # syncs the device
            out["step_s"].append(time.perf_counter() - ts)
            out["losses"].append(loss)
            out["grad_norms"].append(float(metrics["grad_norm"]))
            state = {"params": p, "opt": o,
                     "step": torch.tensor(i + 1, dtype=torch.int32,
                                          device=device)}
            monitor.record_step(time.time() - t0)
            t0 = time.time()
            if i % 20 == 0 or i == args.steps - 1:
                print(f"step {i:5d} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e}", flush=True)
            if ckpt is not None and (i + 1) % args.ckpt_every == 0:
                ckpt.save_async(state, step=i + 1)
            if ph.preempted:
                break
    if ckpt is not None:
        ckpt.wait()
        ckpt.save(state, step=int(state["step"]))
    loader.close()
    print("[train] done;", monitor.summary(), flush=True)
    return {**out, "state": state, "cfg": cfg}


if __name__ == "__main__":
    main()
