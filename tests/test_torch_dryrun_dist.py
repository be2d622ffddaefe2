"""The dry-run's collective recorder against what a rank really issues.

Four ``gloo`` ranks on the CPU run two smoke cells of ``build_cell`` on a
real (2, 2) mesh, with real tensors: a decode step whose KV cache is
split over ``model`` (sequence-parallel attention over heads gathered
over ``model``, vocab-sharded sampling) and a train step (the
tensor-parallel layout with the residual sequence-sharded: FSDP gathers
over ``data``, the residual's gathers and reduce-scatters, the kv head
split between the two ``model`` ranks fetched point to point, the grads'
sums).  Rank 0 counts every collective it
issues, by kind and by result bytes, at the ``torch.distributed`` calls.
The test process runs the same cells as rank 0's program on ``meta``
under an ``AbstractMesh`` of the same shape, and the recorder's counts
must equal rank 0's.  No JAX here: the ranks import only the port.
"""
import os
import sys
import time
from pathlib import Path

import torch

TIMEOUT = 240
ARCH = "qwen2.5-1.5b"
# name -> (seq_len, global batch, kind): small enough for four CPU ranks
CELLS = {"decode": (64, 8, "decode"), "train": (32, 8, "train")}


def _shape(name):
    from repro_torch.configs.base import InputShape

    S, B, kind = CELLS[name]
    return InputShape(f"{name}_small", S, B, kind)


def _materialize(tree, vocab: int, max_len: int, gen):
    """CPU tensors for a cell's meta arguments (values do not steer any
    collective): floats N(0, 0.02), int32 lengths in [1, max_len], other
    int32 tokens below the vocab."""
    def one(name, t):
        if not isinstance(t, torch.Tensor):
            return t
        if t.dtype.is_floating_point:
            return torch.randn(t.shape, generator=gen).to(t.dtype) * 0.02
        if name in ("cache_len", "lengths"):
            return torch.randint(1, max_len + 1, t.shape, generator=gen,
                                 dtype=t.dtype)
        return torch.randint(0, vocab, t.shape, generator=gen,
                             dtype=t.dtype)

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return one(name, node)

    return walk(tree, "")


def _count_issued(record):
    """Wrap the process group calls the port's collectives make, adding
    (1, the result's bytes) by kind (a point-to-point exchange: 1 and the
    bytes received); returns an undo."""
    import torch.distributed as dist

    from repro_torch.distributed import collectives as C

    saved = (dist.all_reduce, C._all_gather_base, C._reduce_scatter_base,
             C._send_recv)

    def add(kind, t):
        d = record.setdefault(kind, {"count": 0, "bytes": 0})
        d["count"] += 1
        d["bytes"] += t.numel() * t.element_size()

    def all_reduce(t, *a, **k):
        add("all-reduce", t)
        return saved[0](t, *a, **k)

    def gather(out, src, *a, **k):
        add("all-gather", out)
        return saved[1](out, src, *a, **k)

    def scatter(out, src, *a, **k):
        add("reduce-scatter", out)
        return saved[2](out, src, *a, **k)

    def send_recv(sends, recvs, *a, **k):
        got = saved[3](sends, recvs, *a, **k)
        d = record.setdefault("collective-permute", {"count": 0, "bytes": 0})
        d["count"] += 1
        d["bytes"] += sum(t.numel() * t.element_size() for t in got)
        return got

    dist.all_reduce = all_reduce
    C._all_gather_base, C._reduce_scatter_base = gather, scatter
    C._send_recv = send_recv

    def undo():
        dist.all_reduce = saved[0]
        C._all_gather_base, C._reduce_scatter_base, C._send_recv = saved[1:]
    return undo


def _rank_main():
    """One rank: each cell on the (2, 2) mesh; rank 0 saves its counts."""
    import torch.distributed as dist

    from repro_torch.configs import inputs as I
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.sharding import ParallelContext
    from repro_torch.launch.mesh import init_distributed, make_host_mesh

    torch.set_num_threads(1)
    rank, _ = init_distributed("gloo", init_method=os.environ["REPRO_INIT"])
    par = ParallelContext(mesh=make_host_mesh(2, 2))
    cfg = get_config(ARCH, smoke=True)
    gen = torch.Generator().manual_seed(rank)
    res = {}
    for name in CELLS:
        cell = I.build_cell(ARCH, _shape(name), par, smoke=True)
        args = tuple(_materialize(a, cfg.vocab_size, CELLS[name][0], gen)
                     for a in cell.args)
        issued: dict = {}
        undo = _count_issued(issued)
        try:
            with torch.set_grad_enabled(cell.kind == "train"):
                cell.fn(*args)
        finally:
            undo()
        res[name] = issued
    if rank == 0:
        torch.save(res, Path(os.environ["REPRO_TEST_OUT"]) / "rank0.pt")
    dist.barrier()
    dist.destroy_process_group()


def test_recorder_counts_what_rank_0_issues(tmp_path):
    from test_torch_distributed import start_ranks, wait_ranks

    from repro_torch.configs import inputs as I
    from repro_torch.distributed.sharding import (AbstractMesh,
                                                  ParallelContext)
    from repro_torch.launch import dryrun as D

    env = {"REPRO_TEST_OUT": str(tmp_path),
           "REPRO_INIT": f"file://{tmp_path / 'pg'}"}
    procs = start_ranks(4, [sys.executable, "-c",
                            "import test_torch_dryrun_dist as t; "
                            "t._rank_main()"], tmp_path, env=env)
    t0 = time.monotonic()
    par = ParallelContext(mesh=AbstractMesh((2, 2), ("data", "model")))
    recorded = {name: D.measure(I.build_cell(ARCH, _shape(name), par,
                                             smoke=True))["collectives"]
                for name in CELLS}
    wait_ranks(procs, tmp_path, timeout=max(1.0, TIMEOUT - (
        time.monotonic() - t0)))
    issued = torch.load(tmp_path / "rank0.pt")
    for name in CELLS:
        assert recorded[name] == issued[name], (name, recorded[name],
                                                issued[name])
    # the decode gathers q, k, v heads over "model" (all-gathers), merges
    # partial softmaxes, sums row-parallel outputs and samples across the
    # vocab shards (all-reduces); the train step gathers and
    # reduce-scatters the sequence-sharded residual and its FSDP weights,
    # and fetches the kv head split between the model ranks point to point
    assert set(recorded["decode"]) == {"all-gather", "all-reduce"}
    assert set(recorded["train"]) == {"all-gather", "all-reduce",
                                      "reduce-scatter", "collective-permute"}
