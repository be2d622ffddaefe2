"""Training entry point of the port, on one device (CUDA unless asked
otherwise) or on a data x model mesh of ranks.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-1.5b \\
      --steps 100 --batch 8 --seq 128 --ckpt-dir runs/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --smoke --device cpu --steps 6 --batch 4 --seq 64
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 4 -m repro_torch.launch.train --mesh 2x2 \\
      --arch qwen2.5-1.5b --steps 3 --batch 8 --seq 128

Random seeded init (seed 0) in ``cfg.param_dtype``, AdamW with 20 warmup
steps over ``--steps``, batches of the synthetic math tasks.  With
``--ckpt-dir`` the state {"params", "opt", "step"} is saved every
``--ckpt-every`` steps (asynchronously), on SIGTERM/SIGINT and at the
end, and relaunching the identical command resumes from the latest
save.

``--mesh DxM``: the ranks of ``torch.distributed.run`` (``RANK``,
``WORLD_SIZE``; D * M of them, else an error) join a process group over
``--backend`` (``nccl`` for CUDA, ``gloo`` for the CPU by default; name
``gloo`` for ranks that share one GPU) and a (data, model) mesh.  Every
rank draws the same global batch and keeps its rows, so a step equals the
single-device step; params and moments live as each rank's blocks
(``train.loop.shard_params``).  Every family computes on its ``model``
blocks with the residual sequence-sharded between layers
(``models.tensor_parallel``; ``shard_activations_seq``).  Checkpoints hold the global arrays in the
JAX format, written by rank 0, and restore onto any mesh
(``distributed.elastic``); after the last save each rank prints the
sha256 of its blocks of the saved state (``tree.digest``), which the
same blocks cut from the restored checkpoint must give.  On CUDA each
rank prints its peak device bytes.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch import tree as T
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.data.dataset import MathDataLoader
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.device import resolve_device
from repro_torch.distributed.elastic import elastic_restore
from repro_torch.distributed.fault_tolerance import (PreemptionHandler,
                                                     StragglerMonitor,
                                                     resume_or_init)
from repro_torch.distributed.sharding import param_specs, stack_layers
from repro_torch.models import api
from repro_torch.train.loop import (LAYER_STACKS, make_train_step,
                                    save_state, shard_params, to_batch)
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
    ap.add_argument("--n-layers", type=int, default=0,
                    help="cut the config's depth to N layers (smoke runs; "
                         "widths untouched)")
    ap.add_argument("--log-every", type=int, default=20,
                    help="print every N-th step's loss (and the last)")
    ap.add_argument("--backend", default=None,
                    help="process-group backend with --mesh (default nccl "
                         "on CUDA, gloo on the CPU)")
    ap.add_argument("--dist-init", default=None,
                    help="process-group init method with --mesh (default "
                         "env://)")
    return ap.parse_args(argv)


def parse_mesh(spec: str) -> tuple:
    try:
        d, m = (int(x) for x in spec.split("x"))
    except ValueError:
        raise SystemExit(f"--mesh takes DxM (e.g. 2x2), got {spec!r}")
    return d, m


def _mesh_context(args, device):
    """(ParallelContext, rank) of ``--mesh``, its group joined."""
    from repro_torch.distributed.sharding import ParallelContext
    from repro_torch.launch.mesh import (default_backend, init_distributed,
                                         make_host_mesh)

    d, m = parse_mesh(args.mesh)
    backend = args.backend or default_backend(device.type)
    rank, world = init_distributed(backend, init_method=args.dist_init)
    if world != d * m:
        raise SystemExit(f"--mesh {args.mesh} needs {d * m} ranks; "
                         f"WORLD_SIZE is {world}")
    # a gloo group lives on the host (and its ranks may share one GPU)
    mesh = make_host_mesh(d, m, device_type=device.type
                          if backend == "nccl" else "cpu")
    return ParallelContext(mesh=mesh, shard_activations_seq=True), rank


def main(argv=None) -> dict:
    """Train and print the JAX entry point's lines.  Returns {"start":
    the step it resumed at, "losses", "grad_norms": per step run, "step_s":
    each step's seconds (ended by a device sync), "state": the final
    {"params", "opt", "step"}, "cfg"}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    par, rank = None, 0
    if args.mesh:
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", int(os.environ.get(
                "LOCAL_RANK", 0)) % torch.cuda.device_count())
        par, rank = _mesh_context(args, device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.n_layers:
        cfg = cfg.with_(n_layers=args.n_layers)
    tok = ByteTokenizer(vocab_size=max(320, cfg.vocab_size))
    if cfg.vocab_size < tok.vocab_size:
        cfg = cfg.with_(vocab_size=tok.vocab_size)
    model = api.get_model(cfg)
    oc = AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps)
    specs = None

    def init():
        nonlocal specs
        p = model.init_params(cfg, seed=0, device=device)
        if par is not None:
            p, specs = shard_params(p, par)
        return {"params": p, "opt": init_opt_state(p),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if par is not None:
        abstract = stack_layers(api.abstract_params(cfg))
        specs = param_specs(abstract, par, stacked_prefixes=LAYER_STACKS)
        template = {"params": abstract, "opt": init_opt_state(abstract),
                    "step": torch.zeros((), dtype=torch.int32,
                                        device="meta")}
        if ckpt is not None and ckpt.latest_step() is not None:
            state, step = elastic_restore(ckpt, template, par, device=device,
                                          stacked_prefixes=LAYER_STACKS)
            if rank == 0:
                print(f"[ft] restored checkpoint at step {step}", flush=True)
        else:
            state = init()
    elif ckpt is not None:
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
    step_fn = make_train_step(cfg, oc, par, microbatches=args.microbatches,
                              specs=specs)

    loader = MathDataLoader(tok, batch_size=args.batch, seq_len=args.seq,
                            host_id=0, n_hosts=1)
    monitor = StragglerMonitor()

    def emergency_save():
        # under a mesh the ranks first agree to stop (below) and then save
        # together after the loop: a gather cannot run in a signal handler
        if ckpt is not None and par is None:
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
            if rank == 0 and (i % args.log_every == 0
                              or i == args.steps - 1):
                print(f"step {i:5d} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e}", flush=True)
            if ckpt is not None and (i + 1) % args.ckpt_every == 0:
                if par is None:
                    ckpt.save_async(state, step=i + 1)
                else:
                    save_state(ckpt, state, specs, par, step=i + 1)
            if _stop(ph.preempted, par, device):
                break
    if ckpt is not None:
        ckpt.wait()
        ts = time.perf_counter()
        save_state(ckpt, state, specs, par, step=int(state["step"]))
        if rank == 0:
            print(f"[ft] checkpoint at step {int(state['step'])} saved in "
                  f"{time.perf_counter() - ts:.3f} s", flush=True)
        if par is not None:
            print(f"[train] rank {rank} state sha256 {T.digest(state)}",
                  flush=True)
    loader.close()
    if device.type == "cuda" and par is not None:
        print(f"[train] rank {rank} peak device bytes "
              f"{torch.cuda.max_memory_allocated(device)}", flush=True)
    if rank == 0:
        print("[train] done;", {**monitor.summary(), "step_s": out["step_s"]},
              flush=True)
    return {**out, "state": state, "cfg": cfg, "par": par, "specs": specs}


def _stop(preempted: bool, par, device) -> bool:
    """Whether to leave the loop: this rank's flag, or under a mesh any
    rank's (so that every rank stops at the same step)."""
    if par is None:
        return preempted
    from repro_torch.distributed import collectives as C

    flag = torch.tensor([int(preempted)], dtype=torch.int32, device=device)
    return bool(C.pmax(flag, par.axes, par.mesh).item())


if __name__ == "__main__":
    main()
