"""Multi-pod dry-run: every (arch x input-shape) cell on the production
mesh, run as rank 0's program on the ``meta`` device, with the roofline
terms of that program.

Run:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all                # 16x16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod    # 2x16x16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k

Outputs one JSON per cell under runs/dryrun/, with the JAX package's
file names and record keys (``repro.launch.dryrun``).

Design.  The JAX package compiles each cell with XLA for 512 emulated
host devices and reads the compiled artifact.  The port has no compiler
to ask: it runs the cell.  ``configs.inputs.build_cell`` gives rank 0's
step and ``meta`` tensors of rank 0's blocks of its arguments; the step
runs on ``meta`` under the mesh's ``sharding.AbstractMesh``, so every
shape is computed and nothing is allocated, and no card is touched.
Each collective returns a ``meta`` result and is recorded, not
performed (``collectives.record_collectives``, backward transposes
included).  Each kernel wrapper checks its operands as the card's kernel
would and returns an empty ``meta`` output, and ``kernels.ops`` reports
the kernel's analytic cost (``kernels.autotune``) to the op hook.
Per device:

  flops          aten FLOPs (``torch.utils.flop_counter``) + the hooked
                 kernels' FLOPs
  bytes_accessed input + output bytes of every aten op that is not a
                 view or an allocation, + the hooked kernels' bytes.  The
                 port runs eagerly, op by op, so this is its traffic (XLA
                 counts a fused program's)
  argument_bytes the arguments' bytes (rank 0's blocks)
  output_bytes   the outputs' bytes; alias_bytes those that share storage
                 with an argument (in-place cache and optimizer writes)
  temp_bytes     the peak of the bytes allocated during the step and live
                 at once (storages tracked by a dispatch mode)
  collectives    count and result bytes by primitive

``lower_s`` is the time to build the cell, ``compile_s`` the time to run
it on ``meta``.  These are counts of the port's program, not
measurements of any device.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
import weakref
from typing import Optional

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import SHAPES_BY_NAME
from repro_torch.configs.registry import cells, get_config
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import ParallelContext, mesh_shape
from repro_torch.kernels import ops

# aten ops that move no bytes: allocations, and views not flagged as such
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "_unsafe_view", "_reshape_alias"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


class _Meter(TorchDispatchMode):
    """Bytes in and out of every op that moves bytes, and the live bytes
    of the storages allocated under the mode (freed when their last
    tensor goes)."""

    def __init__(self, known_storages=()):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._seen = set(known_storages)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        self._seen.add(key)
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)

        def free(key=key, n=n, meter=weakref.ref(self)):
            m = meter()
            if m is not None:
                m.live -= n
                m._seen.discard(key)

        weakref.finalize(st, free)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if not func.is_view and name not in _NO_TRAFFIC:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
        for t in _tensors(out):
            self._track(t)
        return out


def _storages(tree) -> set:
    return {t.untyped_storage()._cdata for t in _tensors(tree)}


def measure(cell, *, kernels: Optional[dict] = None) -> dict:
    """Run ``cell.fn(*cell.args)`` on ``meta`` and count it (see the module
    docstring).  ``kernels``, if given, receives the hooked kernel calls
    {JAX op name: {"calls", "flops", "bytes"}}."""
    hooked = {} if kernels is None else kernels

    def hook(name, flops, hbm_bytes):
        d = hooked.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        d["calls"] += 1
        d["flops"] += flops
        d["bytes"] += hbm_bytes

    args = cell.args
    arg_st = _storages(args)
    meter = _Meter(arg_st)
    prev = ops.set_op_hook(hook)
    try:
        with C.record_collectives() as colls, \
                FlopCounterMode(display=False) as fc, meter, \
                torch.set_grad_enabled(cell.kind == "train"):
            out = cell.fn(*args)
    finally:
        ops.set_op_hook(prev)
    outs = _tensors(out)
    kflops = sum(d["flops"] for d in hooked.values())
    kbytes = sum(d["bytes"] for d in hooked.values())
    return {
        "flops": float(fc.get_total_flops()) + kflops,
        "bytes_accessed": float(meter.bytes) + kbytes,
        "argument_bytes": sum(_nbytes(t) for t in _tensors(args)),
        "output_bytes": sum(_nbytes(t) for t in outs),
        "temp_bytes": meter.peak,
        "alias_bytes": sum(_nbytes(t) for t in outs
                           if t.untyped_storage()._cdata in arg_st),
        "collectives": {k: dict(v) for k, v in colls.items()},
    }


def cost_analysis_dict(per_device: dict) -> dict:
    """A measured cell's costs under the keys of XLA's
    ``Compiled.cost_analysis()`` (the JAX package's
    ``compat.cost_analysis_dict``): "flops" and "bytes accessed"."""
    return {"flops": per_device["flops"],
            "bytes accessed": per_device["bytes_accessed"]}


# ---------------------------------------------------------------------------
# Cell runner
# ---------------------------------------------------------------------------


def run_cell(arch: str, shape_name: str, par: ParallelContext,
             out_dir: str = "runs/dryrun", mesh_tag: str = "",
             quantized: bool = False, *,
             kernels: Optional[dict] = None) -> dict:
    from repro_torch.configs.inputs import build_cell

    shape = SHAPES_BY_NAME[shape_name]
    t0 = time.time()
    cell = build_cell(arch, shape, par, quantized=quantized)
    t_lower = time.time() - t0
    t0 = time.time()
    m = measure(cell, kernels=kernels)
    t_compile = time.time() - t0
    ca = cost_analysis_dict(m)
    n_devices = math.prod(mesh_shape(par.mesh).values()) \
        if par.mesh is not None else 1

    rec = {
        "arch": arch,
        "shape": shape_name,
        "quantized": quantized,
        "mesh": mesh_tag,
        "n_devices": n_devices,
        "kind": shape.kind,
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_compile, 2),
        "per_device": {
            "flops": ca.get("flops", 0.0),
            "bytes_accessed": ca.get("bytes accessed", 0.0),
            "argument_bytes": m["argument_bytes"],
            "output_bytes": m["output_bytes"],
            "temp_bytes": m["temp_bytes"],
            "alias_bytes": m["alias_bytes"],
        },
        "collectives": m["collectives"],
        "param_count": get_config(arch).param_count(),
        "param_count_active": get_config(arch).param_count(active_only=True),
    }
    os.makedirs(out_dir, exist_ok=True)
    qtag = "__q4" if quantized else ""
    fname = f"{arch.replace('.', '_')}__{shape_name}__{mesh_tag}{qtag}.json"
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    from repro_torch.launch.mesh import abstract_production_mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="runs/dryrun")
    ap.add_argument("--continue-on-error", action="store_true")
    ap.add_argument("--quantized", action="store_true",
                    help="serve cells with tile-Q4 weights (paper deployment)")
    ap.add_argument("--layout", default="tp", choices=["tp", "fsdp"],
                    help="fsdp: no tensor parallelism (model axis = 2nd "
                         "FSDP axis)")
    args = ap.parse_args(argv)

    mesh = abstract_production_mesh(multi_pod=args.multi_pod)
    mesh_tag = "2x16x16" if args.multi_pod else "16x16"
    par = ParallelContext(mesh=mesh, tp=(args.layout == "tp"))
    if args.layout != "tp":
        mesh_tag += "_fsdp"
    print(f"[dryrun] mesh {mesh_tag}: {math.prod(mesh.shape)} devices, axes "
          f"{mesh.mesh_dim_names}", flush=True)

    todo = []
    if args.all:
        for arch, shape, runnable, reason in cells():
            if runnable:
                todo.append((arch, shape.name))
            else:
                print(f"[dryrun] SKIP {arch}:{shape.name} — {reason}",
                      flush=True)
    else:
        assert args.arch and args.shape
        todo = [(args.arch, args.shape)]

    failures = []
    for arch, shape_name in todo:
        print(f"[dryrun] {arch}:{shape_name} ({mesh_tag}) ...",
              end=" ", flush=True)
        try:
            rec = run_cell(arch, shape_name, par, out_dir=args.out,
                           mesh_tag=mesh_tag, quantized=args.quantized)
            pd = rec["per_device"]
            print(f"ok lower={rec['lower_s']}s compile={rec['compile_s']}s "
                  f"flops/dev={pd['flops']:.3e} "
                  f"args/dev={pd['argument_bytes']/2**20:.0f}MiB "
                  f"temp/dev={pd['temp_bytes']/2**20:.0f}MiB", flush=True)
        except Exception as e:  # noqa
            print(f"FAIL: {type(e).__name__}: {e}", flush=True)
            failures.append((arch, shape_name, traceback.format_exc()))
            if not args.continue_on_error:
                traceback.print_exc()
                sys.exit(1)
    if failures:
        print(f"[dryrun] {len(failures)} failures:")
        for a, s, tb in failures:
            print(f"  {a}:{s}\n{tb}")
        sys.exit(1)
    print(f"[dryrun] all {len(todo)} cells ran OK on {mesh_tag}")


if __name__ == "__main__":
    main()
