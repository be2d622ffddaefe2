"""The transformer family's per-device layout (``models.tensor_parallel``):
compute on each weight's ``model`` block, rows on their ``data`` block.

- On ``meta`` under an ``AbstractMesh`` of (2, 2), the collective
  recorder's counts and bytes per layer: with the residual
  sequence-sharded, two all-gathers and two reduce-scatters of the
  residual a layer forward and their transposes backward; without it,
  two ``psum``s a layer each way; and no all-gather over ``model`` whose
  operand or result has a weight leaf's shape, in the train, prefill and
  decode cells of qwen2.5-1.5b, mamba2-130m, zamba2-1.2b and whisper-base
  (the other families' own tests: ``tests/test_torch_tp_families.py``).
- On four ``gloo`` ranks of a real (2, 2) mesh (no JAX in the ranks), the
  tensor-parallel prefill and decode against the same program on one
  rank: the rank's vocab block of its rows' logits, and its part of the
  cache, for the qwen2.5-1.5b smoke config (q heads whole on each rank,
  its one kv head split in two) and a three-head config whose q heads
  split between the ranks too.  (The dry-run cells' collectives on real
  ranks are ``tests/test_torch_dryrun_dist.py``'s.)
"""
import os
import sys
import time
from pathlib import Path

import pytest
import torch

ARCH = "qwen2.5-1.5b"
TIMEOUT = 240
TOL = 1e-5
B, S, STEPS = 4, 24, 3


def _odd_cfg():
    """Three heads of 16 over one kv head: on a model axis of 2 each rank
    holds 1.5 q heads and half the kv head."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(name="odd", n_layers=2, d_model=48, n_heads=3,
                       n_kv_heads=1, d_ff=96, vocab_size=320,
                       dtype="float32", param_dtype="float32", remat="none")


def _tiny(**kw):
    from repro_torch.configs.base import ModelConfig
    base = dict(name="tiny", n_layers=3, d_model=64, n_heads=4,
                n_kv_heads=2, d_ff=128, vocab_size=320, dtype="float32",
                param_dtype="float32", remat="none")
    return ModelConfig(**{**base, **kw})


# -- the recorder on meta ----------------------------------------------------


def _meta_step(cfg, seq: bool, calls=None):
    """Rank 0's forward and backward of the loss on ``meta`` under an
    AbstractMesh (2, 2) (weights as their model blocks, rows split over
    data): the recorded collectives over ``model``."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import (AbstractMesh,
                                                  ParallelContext)
    from repro_torch.models import api
    from repro_torch.models import tensor_parallel as TP
    from repro_torch.train.loop import local_view, shard_params

    par = ParallelContext(mesh=AbstractMesh((2, 2), ("data", "model")),
                          shard_activations_seq=seq)
    blocks, specs = shard_params(api.abstract_params(cfg), par)
    leaves = [t.requires_grad_(True) for t in _leaves(blocks)]
    tp = TP.TPLayout(par, rows="data")
    toks = torch.empty((B // 2, S), dtype=torch.int32, device="meta")
    calls = [] if calls is None else calls
    with C.record_collectives(calls):
        logits, _ = TP.forward(local_view(blocks, specs, par), toks, cfg, tp)
        nll = TP.token_nll(logits, toks, cfg, tp)
        torch.autograd.grad(nll.sum(), leaves)
    return [c for c in calls if c[1] == ("model",)]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _count(calls, kind, shape=None):
    return sum(1 for k, _, s, _ in calls if k == kind and
               (shape is None or s == shape))


@pytest.mark.parametrize("seq", [True, False], ids=["seq", "psum"])
def test_recorder_counts_the_layout_per_layer(seq):
    """tiny (3 layers, d 64, heads and kv heads whole on each model rank),
    rows 2 a rank, S 24.  Sequence-sharded: per layer forward 2
    all-gathers of the (2, 12, 64) residual block to (2, 24, 64) and 2
    reduce-scatters back, plus the embedding's reduce-scatter and the
    final norm's all-gather; backward the transpose of each.  Without it:
    2 psums of (2, 24, 64) per layer forward and 2 backward, plus the
    embedding's.  Either way the loss adds four all-reduces of (2, 24)
    (max, sum of exponentials, target logit; the backward's sum)."""
    cfg = _tiny()
    L = cfg.n_layers
    calls = _meta_step(cfg, seq)
    whole, block, rows = (2, S, 64), (2, S // 2, 64), (2, S)
    n = 2 * (2 * L + 1)  # forward and backward
    if seq:
        assert _count(calls, "all-gather", block) == n
        assert _count(calls, "reduce-scatter", whole) == n
        assert _count(calls, "all-gather") == n
        assert _count(calls, "reduce-scatter") == n
        assert _count(calls, "all-reduce", whole) == 0
    else:
        assert _count(calls, "all-reduce", whole) == n
        assert _count(calls, "all-gather") == 0
        assert _count(calls, "reduce-scatter") == 0
    assert _count(calls, "all-reduce", rows) == 4
    assert _count(calls, "collective-permute") == 0


def test_recorder_bytes_per_layer():
    """The sequence-sharded layout's bytes: each all-gather's result is
    the whole (2, 24, 64) f32 residual, each reduce-scatter's the half."""
    calls = _meta_step(_tiny(), True)
    n = 2 * (2 * _tiny().n_layers + 1)
    for kind, each in (("all-gather", 2 * S * 64 * 4),
                       ("reduce-scatter", 2 * (S // 2) * 64 * 4)):
        got = [b for k, _, _, b in calls if k == kind]
        assert got == [each] * n, (kind, got)


# (arch, cell): the transformer family's cells keep their ids
NO_GATHER_CASES = [(a, s) for a in (ARCH, "mamba2-130m", "zamba2-1.2b",
                                    "whisper-base")
                   for s in ("train", "prefill", "decode")]


@pytest.mark.parametrize("arch,shape", NO_GATHER_CASES,
                         ids=[s if a == ARCH else f"{a}-{s}"
                              for a, s in NO_GATHER_CASES])
def test_no_weight_is_gathered_over_model(arch, shape):
    """The smoke cells of qwen2.5-1.5b, mamba2-130m, zamba2-1.2b and
    whisper-base on an AbstractMesh (2, 2): no all-gather over ``model``
    has an operand or a result of a weight leaf's shape (global, per
    layer, the rank's block, or gathered over ``data``), while the cells
    do move activations over ``model``."""
    from repro_torch.configs import inputs as I
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import (AbstractMesh,
                                                  ParallelContext,
                                                  local_shape)
    from repro_torch.launch import dryrun as D

    par = ParallelContext(mesh=AbstractMesh((2, 2), ("data", "model")))
    kinds = {"train": (32, 8, "train"), "prefill": (32, 8, "prefill"),
             "decode": (64, 8, "decode")}
    S_, B_, kind = kinds[shape]
    cell = I.build_cell(arch, InputShape(f"{shape}_small", S_, B_, kind),
                        par, smoke=True)
    weights = set()
    for g, spec in zip(_leaves(cell.global_args[0]), _leaves_spec(
            cell.specs[0])):
        full = tuple(g.shape)
        on_model = tuple("model" if e is not None and "model" in (
            (e,) if isinstance(e, str) else e) else None for e in spec)
        for s in (full, local_shape(full, spec, par),
                  local_shape(full, on_model, par)):
            weights.update({s, s[1:]})  # stacked and per layer
    calls = []
    with C.record_collectives(calls):
        D.measure(cell)
    assert any("model" in a for _, a, _, _ in calls), \
        "the cell moves nothing over model"
    over_model = [(k, s) for k, a, s, _ in calls
                  if k == "all-gather" and "model" in a]
    for k, s in over_model:
        res = s[:-1] + (s[-1] * 2,)
        assert s not in weights and res not in weights, (k, s)


def _leaves_spec(specs):
    if isinstance(specs, dict):
        for v in specs.values():
            yield from _leaves_spec(v)
    else:
        yield specs


# -- four ranks against one --------------------------------------------------


def _tokens(cfg, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(3, cfg.vocab_size - 3, (B, S + STEPS), generator=g,
                         dtype=torch.int32)


def _params(cfg):
    from repro_torch.models import transformer as TM
    return TM.init_params(cfg, seed=0, device="cpu")


def _one_rank(cfg):
    """Prefill logits and cache, then STEPS teacher-forced decode logits
    and the final cache, on one rank."""
    from repro_torch.models import transformer as TM

    p, toks = _params(cfg), _tokens(cfg, 1)
    lens = torch.full((B,), S, dtype=torch.int32)
    cache = TM.init_cache(cfg, B, S + STEPS + 1, device="cpu")
    with torch.no_grad():
        first = TM.prefill(p, toks[:, :S], cfg, lengths=lens, cache=cache)
        pre = {k: v[:, :, :S].clone() for k, v in cache.items()}
        steps = [TM.decode_step(p, toks[:, S + i:S + i + 1], cache,
                                torch.full((B,), S + i + 1,
                                           dtype=torch.int32), cfg)
                 for i in range(STEPS)]
    return {"prefill": first, "pre_cache": pre, "decode": torch.stack(steps),
            "cache": cache}


def _tp_rank(cfg, mesh):
    """The same on this rank of the (2, 2) mesh: prefill over its rows
    with its weight blocks, then the sequence-parallel decode over its
    block of the prefilled cache (split along the sequence over
    ``model``)."""
    import dataclasses

    from repro_torch.distributed.sharding import ParallelContext, shard_of
    from repro_torch.models import tensor_parallel as TP
    from repro_torch.train.loop import local_view, shard_params

    par = ParallelContext(mesh=mesh, fsdp=False)
    p, toks = _params(cfg), _tokens(cfg, 1)
    blocks, specs = shard_params(p, par)
    view = local_view(blocks, specs, par)
    tp = TP.TPLayout(par, rows="data")
    rows = lambda t: shard_of(t, ("data",), par)  # noqa: E731
    lo, hi = TP.kv_heads_read(cfg, tp.m, tp.r)
    hd = cfg.resolved_head_dim()
    cache = {n: torch.zeros((cfg.n_layers, B // 2, S, hi - lo, hd))
             for n in ("k", "v")}
    lens = torch.full((B // 2,), S, dtype=torch.int32)
    with torch.no_grad():
        first = TP.prefill(view, rows(toks[:, :S]), cfg, tp, lengths=lens,
                           cache=cache)
        # the decode's cache: rows on data, the sequence over model, from
        # the one-rank prefill (the same values the ranks wrote)
        one = _one_rank(cfg)["pre_cache"]
        dpar = dataclasses.replace(par, kv_seq_axis="model")
        dtp = TP.TPLayout(dpar, rows="data")
        full = {k: torch.zeros((cfg.n_layers, B, S + STEPS + 1) + v.shape[3:])
                for k, v in one.items()}
        for k in full:
            full[k][:, :, :S] = one[k]
        spec = (None, "data", "model")
        local = {k: shard_of(v, spec, dpar).clone() for k, v in full.items()}
        steps = [TP.decode_step(view, rows(toks[:, S + i:S + i + 1]), local,
                                torch.full((B // 2,), S + i + 1,
                                           dtype=torch.int32), cfg, dtp)
                 for i in range(STEPS)]
    return {"prefill": first, "cache": cache, "decode": torch.stack(steps),
            "dec_cache": local, "kv": (lo, hi)}


def _rank_main():
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_host_mesh

    torch.set_num_threads(1)
    rank, _ = init_distributed("gloo", init_method=os.environ["REPRO_INIT"])
    mesh = make_host_mesh(2, 2)
    from repro_torch.configs.registry import get_config
    res = {"coord": mesh.get_coordinate()}
    for name, cfg in (("qwen", get_config(ARCH, smoke=True)),
                      ("odd", _odd_cfg())):
        res[name] = _tp_rank(cfg, mesh)
    torch.save(res, Path(os.environ["REPRO_TEST_OUT"]) / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from test_torch_distributed import start_ranks, wait_ranks

    out = tmp_path_factory.mktemp("tp")
    procs = start_ranks(4, [sys.executable, "-c",
                            "import test_torch_tp as t; t._rank_main()"],
                        out, env={"REPRO_TEST_OUT": str(out),
                                  "REPRO_INIT": f"file://{out / 'pg'}"})
    t0 = time.monotonic()
    from repro_torch.configs.registry import get_config
    refs = {"qwen": _one_rank(get_config(ARCH, smoke=True)),
            "odd": _one_rank(_odd_cfg())}
    wait_ranks(procs, out, timeout=max(1.0, TIMEOUT - (time.monotonic()
                                                       - t0)))
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(4)], refs


@pytest.mark.parametrize("name", ["qwen", "odd"])
def test_prefill_matches_one_rank(ranks, name):
    """Each rank's vocab block of its rows' last-position logits, and the
    kv heads it read for its rows' cache, within 1e-5 of one rank's."""
    res, refs = ranks
    want = refs[name]
    for r in res:
        d, m = r["coord"]
        got = r[name]
        rows = slice(d * B // 2, (d + 1) * B // 2)
        V = want["prefill"].shape[-1]
        vb = slice(m * V // 2, (m + 1) * V // 2)
        torch.testing.assert_close(got["prefill"], want["prefill"][rows, vb],
                                   atol=TOL, rtol=0)
        lo, hi = got["kv"]
        for k in ("k", "v"):
            torch.testing.assert_close(
                got["cache"][k], want["pre_cache"][k][:, rows, :, lo:hi],
                atol=TOL, rtol=0)


@pytest.mark.parametrize("name", ["qwen", "odd"])
def test_decode_matches_one_rank(ranks, name):
    """STEPS teacher-forced steps of the tensor-parallel decode (heads
    gathered over ``model``, the cache split along the sequence over it):
    each rank's vocab block of its rows' logits, and its block of the
    written cache, within 1e-5 of one rank's."""
    res, refs = ranks
    want = refs[name]
    for r in res:
        d, m = r["coord"]
        got = r[name]
        rows = slice(d * B // 2, (d + 1) * B // 2)
        V = want["decode"].shape[-1]
        vb = slice(m * V // 2, (m + 1) * V // 2)
        torch.testing.assert_close(got["decode"], want["decode"][:, rows, vb],
                                   atol=TOL, rtol=0)
        n = want["cache"]["k"].shape[2] // 2
        for k in ("k", "v"):
            torch.testing.assert_close(
                got["dec_cache"][k],
                want["cache"][k][:, rows, m * n:(m + 1) * n], atol=TOL,
                rtol=0)
