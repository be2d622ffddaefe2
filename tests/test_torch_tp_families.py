"""Mamba2, the zamba2 hybrid and Whisper on the per-device layout
(``models.tp_mamba2``, ``models.tp_whisper``): compute on each weight's
and cache leaf's ``model`` block.

- On four ``gloo`` ranks of a real (1, 4) mesh (no JAX in the ranks), the
  tensor-parallel prefill and three teacher-forced decode steps against
  the same program on one rank: the rank's vocab block of the logits and
  its part of every cache leaf, within 1e-5 (f32).  The configs: the
  mamba2 and zamba2 smoke configs (``in_proj`` N 296, 74 columns a rank,
  not on its [z | x | B | C | dt] split), a Mamba2 of 6 heads (heads,
  ``A_log`` and ``in_proj`` whole on 4, ``out_proj`` 1.5 heads a rank),
  the Whisper smoke config (a head a rank), a Whisper of 2 heads, whose
  cache is split on head_dim, and a W4A16 hybrid whose Q4 ``in_proj``
  block does not tile (kept whole).  Every bias, norm and per-head
  vector is drawn at random, so a block taken at the wrong offset or a
  replicated bias added on every rank shows.  Each rank's collectives
  equal the same program's run as that rank on ``meta``.
- On ``meta`` under an ``AbstractMesh`` of (2, 2), the collective
  recorder's counts and bytes per layer of a training step (forward and
  backward) of each family's smoke config.
"""
import os
import sys
import time
from pathlib import Path

import pytest
import torch

TIMEOUT = 240
TOL = 1e-5
B, S, STEPS = 2, 24, 3
MAX_LEN = S + STEPS + 1  # 28: the decode cache splits 4 ways along it
NAMES = ["mamba2", "zamba2", "mamba6", "whisper", "whisper2", "hybrid-q4"]


def _mamba6():
    """Six heads of 16: on a model axis of 4 the heads, A_log / dt_bias /
    D and in_proj (N 230) are whole, conv (128) and out_proj's 96 rows
    split, a rank computing 2, 1, 2 and 1 heads."""
    from repro_torch.configs.base import ModelConfig, SSMConfig
    return ModelConfig(name="mamba6", family="mamba2", n_layers=2,
                       d_model=48, n_heads=0, n_kv_heads=0, d_ff=0,
                       vocab_size=512, tie_embeddings=True,
                       ssm=SSMConfig(d_state=16, head_dim=16, expand=2,
                                     conv_width=4, chunk_size=8),
                       dtype="float32", remat="none")


def _whisper2():
    """Two heads of 16 on a model axis of 4: q heads on ranks 0 and 2, the
    cache split on head_dim (4 dims of each head a rank)."""
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(name="whisper2", family="encdec", n_layers=2,
                       n_encoder_layers=2, d_model=32, n_heads=2,
                       n_kv_heads=2, head_dim=16, d_ff=64, vocab_size=512,
                       qkv_bias=True, rope_theta=0.0, encoder_seq_len=24,
                       max_seq_len=128, tie_embeddings=True, dtype="float32",
                       remat="none")


def _hybrid_q4():
    """A zamba2-style hybrid whose every projection tiles into (2, 16) Q4
    groups, served W4A16: ``in_proj`` 64 -> 2 x 128 + 2 x 8 + 16 = 288,
    whose 72-column block on 4 ranks is no whole number of 16-column
    scale groups (18 groups of 4 ranks), so the layout keeps it whole and
    gathers its codes; every other Q4 leaf splits."""
    from repro_torch.configs.base import ModelConfig, SSMConfig
    return ModelConfig(name="hybrid-q4", family="hybrid", n_layers=4,
                       d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
                       d_ff=128, vocab_size=512, hybrid_attn_every=2,
                       ssm=SSMConfig(d_state=8, head_dim=8, expand=2,
                                     conv_width=4, chunk_size=8),
                       dtype="float32", remat="none")


def _cfg(name):
    from repro_torch.configs.registry import get_config
    if name == "hybrid-q4":
        return _hybrid_q4()
    if name == "mamba6":
        return _mamba6()
    if name == "whisper2":
        return _whisper2()
    arch = {"mamba2": "mamba2-130m", "zamba2": "zamba2-1.2b",
            "whisper": "whisper-base"}[name]
    return get_config(arch, smoke=True).with_(remat="none")


def _params(cfg):
    """The port's init (seed 0) with every bias, norm and per-head vector
    drawn at random."""
    from repro_torch import tree as T
    from repro_torch.models import api

    p = api.get_model(cfg).init_params(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(5)

    def one(path, t):
        last = path[-1]
        if last in ("b", "bias", "A_log", "dt_bias", "D"):
            return t + 0.3 * torch.randn(t.shape, generator=g).to(t.dtype)
        if last == "scale":
            return t * (1 + 0.3 * torch.randn(t.shape, generator=g))
        return t
    p = T.map_with_path(one, p)
    if cfg.name == "hybrid-q4":
        from repro_torch.quant.qlinear import quantize_model_params
        p = quantize_model_params(p)
    return p


def _inputs(cfg):
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(3, cfg.vocab_size - 3, (B, S + STEPS), generator=g,
                         dtype=torch.int32)
    frames = None
    if cfg.family == "encdec":
        frames = torch.randn((B, cfg.encoder_seq_len, cfg.d_model),
                             generator=g)
    return toks, frames


def _one_rank(cfg):
    """Prefill logits and cache, then STEPS teacher-forced decode logits
    and the final cache, on one rank."""
    from repro_torch.models import api

    model = api.get_model(cfg)
    p, (toks, frames) = _params(cfg), _inputs(cfg)
    lens = torch.full((B,), S, dtype=torch.int32)
    kw = {"embeddings": frames} if frames is not None else {}
    cache = model.init_cache(cfg, B, MAX_LEN, device="cpu")
    with torch.no_grad():
        first = model.prefill(p, toks[:, :S], cfg, lengths=lens, cache=cache,
                              **kw)
        pre = {k: v.clone() for k, v in cache.items()}
        steps = [model.decode_step(p, toks[:, S + i:S + i + 1], cache,
                                   torch.full((B,), S + i + 1,
                                              dtype=torch.int32), cfg)
                 for i in range(STEPS)]
    return {"prefill": first, "pre_cache": pre, "decode": torch.stack(steps),
            "cache": cache}


def _decode_par(cfg, par):
    import dataclasses
    return dataclasses.replace(par, kv_seq_axis="model") \
        if cfg.family == "hybrid" else par


def _program(cfg, view, par, cache, local, toks, frames):
    """Prefill into ``cache`` (the rank's part), then STEPS teacher-forced
    decode steps over ``local`` (its blocks of the one-rank prefill's
    cache) and, for the hybrid, over ``tp_mamba2.decode_cache`` of its
    own prefill's cache.  Returns (prefill logits, step logits, that
    cache or None)."""
    from repro_torch.models import tensor_parallel as TP

    fam = TP.family(cfg)
    tp = TP.TPLayout(par, rows="data")
    lens = torch.full((B,), S, dtype=torch.int32, device=toks.device)
    kw = {"embeddings": frames} if frames is not None else {}
    first = fam.prefill(view, toks[:, :S], cfg, tp, lengths=lens,
                        cache=cache, **kw)
    dtp = TP.TPLayout(_decode_par(cfg, par), rows="data")

    def steps(c):
        return [fam.decode_step(view, toks[:, S + i:S + i + 1], c, lens + i + 1,
                                cfg, dtp) for i in range(STEPS)]

    out = steps(local)
    own = None
    if cfg.family == "hybrid":  # from the rank's own prefill's cache
        own = fam.decode_cache({k: v.clone() for k, v in cache.items()},
                               cfg, dtp, MAX_LEN, S)
        steps(own)
    return first, out, own


def _tp_rank(cfg, mesh):
    """The same on this rank of the (1, 4) mesh: prefill with its weight
    blocks into its part of the cache, then the decode over its blocks of
    the one-rank prefill's cache (``configs.inputs.cache_specs``; the
    hybrid's attention cache split along the sequence over ``model``).
    The collectives it issues, and those of the same program run as this
    rank on ``meta`` under an AbstractMesh of (1, 4)."""
    import dataclasses

    from repro_torch import tree as T
    from repro_torch.configs.inputs import cache_specs
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import (AbstractMesh,
                                                  ParallelContext, shard_of)
    from repro_torch.models import tensor_parallel as TP
    from repro_torch.train.loop import local_view, shard_params

    par = ParallelContext(mesh=mesh, fsdp=False)
    p, (toks, frames) = _params(cfg), _inputs(cfg)
    blocks, specs = shard_params(p, par)
    tp = TP.TPLayout(par, rows="data")
    one = _one_rank(cfg)["pre_cache"]
    dpar = _decode_par(cfg, par)
    cspecs = cache_specs(cfg, dpar, one, B)
    local = {k: shard_of(v, cspecs[k], dpar).clone() for k, v in one.items()}
    cache = TP.family(cfg).init_cache(cfg, tp, B, S, device="cpu")
    meta = lambda tree: T.map_with_path(  # noqa: E731
        lambda _, t: t.to("meta"), tree)
    apar = dataclasses.replace(par, mesh=AbstractMesh(
        (1, 4), ("data", "model"), coordinate=tuple(mesh.get_coordinate())))
    mcache, mlocal = meta(cache), meta(local)
    with torch.no_grad():
        with C.record_collectives() as rec:
            first, steps, own = _program(cfg, local_view(blocks, specs, par),
                                         par, cache, local, toks, frames)
        with C.record_collectives() as mrec:
            _program(cfg, local_view(meta(blocks), specs, apar), apar, mcache,
                     mlocal, toks.to("meta"),
                     None if frames is None else frames.to("meta"))
    kv = TP.kv_heads_read(cfg, tp.m, tp.r) if cfg.family == "hybrid" \
        else None
    return {"prefill": first, "cache": cache, "decode": torch.stack(steps),
            "dec_cache": local, "kv": kv, "own_cache": own,
            "collectives": rec, "collectives_meta": mrec}


def _rank_main():
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_host_mesh

    torch.set_num_threads(1)
    rank, _ = init_distributed("gloo", init_method=os.environ["REPRO_INIT"])
    mesh = make_host_mesh(1, 4)
    res = {"coord": mesh.get_coordinate()}
    for name in NAMES:
        res[name] = _tp_rank(_cfg(name), mesh)
    torch.save(res, Path(os.environ["REPRO_TEST_OUT"]) / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from test_torch_distributed import start_ranks, wait_ranks

    out = tmp_path_factory.mktemp("tpf")
    procs = start_ranks(4, [sys.executable, "-c",
                            "import test_torch_tp_families as t; "
                            "t._rank_main()"],
                        out, env={"REPRO_TEST_OUT": str(out),
                                  "REPRO_INIT": f"file://{out / 'pg'}"})
    t0 = time.monotonic()
    refs = {name: _one_rank(_cfg(name)) for name in NAMES}
    wait_ranks(procs, out, timeout=max(1.0, TIMEOUT - (time.monotonic()
                                                       - t0)))
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(4)], refs


def _shard(cfg, full, coord, prefill: bool, kv):
    """The part of the one-rank cache ``full`` that the rank at ``coord``
    of (1, 4) keeps: each leaf's block of ``cache_specs``; at prefill the
    hybrid's attention leaves are the kv heads the rank read, and every
    self-attention leaf its first S slots."""
    from repro_torch.configs.inputs import cache_specs
    from repro_torch.distributed.sharding import (AbstractMesh,
                                                  ParallelContext, shard_of)

    par = _decode_par(cfg, ParallelContext(
        mesh=AbstractMesh((1, 4), ("data", "model")), fsdp=False))
    at = {"data": coord[0], "model": coord[1]}
    cspecs = cache_specs(cfg, par, full, B)
    out = {}
    for k, v in full.items():
        if prefill and k in ("attn_k", "attn_v"):
            out[k] = v[:, :, :S, kv[0]:kv[1]]
            continue
        t = shard_of(v, cspecs[k], par, coord=at)
        out[k] = t[:, :, :S] if prefill and k in ("k", "v") else t
    return out


@pytest.mark.parametrize("name", NAMES)
def test_prefill_matches_one_rank(ranks, name):
    """Each rank's vocab block of the last-position logits, and its part
    of every cache leaf (its conv channels and SSM heads, the kv heads it
    read, its heads or head_dim block of Whisper's K/V), within 1e-5 of
    one rank's."""
    res, refs = ranks
    want = refs[name]
    cfg = _cfg(name)
    for r in res:
        m = r["coord"][1]
        got = r[name]
        V = want["prefill"].shape[-1]
        vb = slice(m * V // 4, (m + 1) * V // 4)
        torch.testing.assert_close(got["prefill"], want["prefill"][:, vb],
                                   atol=TOL, rtol=0)
        exp = _shard(cfg, want["pre_cache"], r["coord"], True, got["kv"])
        assert sorted(got["cache"]) == sorted(exp)
        for k in exp:
            torch.testing.assert_close(got["cache"][k], exp[k], atol=TOL,
                                       rtol=0, msg=f"{name} {k}")


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_one_rank(ranks, name):
    """STEPS teacher-forced steps over the rank's cache blocks: its vocab
    block of the logits and its block of every written cache leaf within
    1e-5 of one rank's; the hybrid's cache, started from the rank's own
    prefill (``tp_mamba2.decode_cache``: the attention leaves' heads
    fetched from their ranks, cut to the rank's slots), ends the same."""
    res, refs = ranks
    want = refs[name]
    cfg = _cfg(name)
    for r in res:
        m = r["coord"][1]
        got = r[name]
        V = want["decode"].shape[-1]
        vb = slice(m * V // 4, (m + 1) * V // 4)
        torch.testing.assert_close(got["decode"], want["decode"][:, :, vb],
                                   atol=TOL, rtol=0)
        exp = _shard(cfg, want["cache"], r["coord"], False, None)
        for k in exp:
            torch.testing.assert_close(got["dec_cache"][k], exp[k], atol=TOL,
                                       rtol=0, msg=f"{name} {k}")
            if got["own_cache"] is not None:  # decode_cache's, the same
                torch.testing.assert_close(got["own_cache"][k], exp[k],
                                           atol=TOL, rtol=0,
                                           msg=f"{name} {k} (own)")


@pytest.mark.parametrize("name", NAMES)
def test_collectives_equal_the_meta_count_per_rank(ranks, name):
    """The collectives each rank issues (count and bytes by kind) equal
    those of the same program run as that rank (``AbstractMesh(...,
    coordinate=)``) on ``meta``: the point-to-point regroups differ
    between ranks (mamba6's heads split 2, 1, 2, 1)."""
    res, _ = ranks
    for r in res:
        got = r[name]
        assert got["collectives"] == got["collectives_meta"], (r["coord"],
                                                              got)
        assert got["collectives"], "the program issues no collective"


# -- the recorder on meta ----------------------------------------------------


def _meta_step(cfg, seq: bool):
    """Rank 0's forward and backward of the loss on ``meta`` under an
    AbstractMesh (2, 2) (weights as their model blocks, rows split over
    data): the recorded collectives over ``model``, as a count per (kind,
    bytes)."""
    from collections import Counter

    from repro_torch import tree as T
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import (AbstractMesh,
                                                  ParallelContext)
    from repro_torch.models import api
    from repro_torch.models import tensor_parallel as TP
    from repro_torch.train.loop import local_view, shard_params

    par = ParallelContext(mesh=AbstractMesh((2, 2), ("data", "model")),
                          shard_activations_seq=seq)
    blocks, specs = shard_params(api.abstract_params(cfg), par)
    leaves = [t.requires_grad_(True) for t in T.flatten(blocks)[0]]
    tp = TP.TPLayout(par, rows="data")
    toks = torch.empty((B, S), dtype=torch.int32, device="meta")
    kw = {}
    if cfg.family == "encdec":
        kw["embeddings"] = torch.empty((B, cfg.encoder_seq_len,
                                        cfg.d_model), device="meta")
    calls = []
    with C.record_collectives(calls):
        logits, _ = TP.family(cfg).forward(local_view(blocks, specs, par),
                                           toks, cfg, tp, **kw)
        nll = TP.token_nll(logits, toks, cfg, tp)
        torch.autograd.grad(nll.sum(), leaves)
    return Counter((k, b) for k, a, _, b in calls if a == ("model",))


@pytest.mark.parametrize("seq", [False, True], ids=["psum", "seq"])
@pytest.mark.parametrize("name", ["mamba2", "zamba2", "whisper"])
def test_recorder_counts_the_layout_per_layer(name, seq):
    """The smoke configs (d 64; rows 2 a rank, S 24, f32) on (2, 2).  A
    residual-sized collective (whole: 2 x 24 x 64 x 4 = 12,288 bytes,
    half along the sequence: 6,144) per row-parallel projection and at
    the embedding, forward and backward: ``psum``s, or with the residual
    sequence-sharded an all-gather before each column-parallel input and
    the final norm and a reduce-scatter after each row-parallel output
    (the transposes backward).  A Mamba2 layer adds, each way, the
    ``psum`` of its gated norm's sums of squares (2 x 24 x 4 = 192 bytes)
    and two point-to-point regroups: rank 0 holds ``in_proj`` columns [0,
    148) and takes [148, 208) of its conv block and its 4 dt columns (64
    columns, 12,288 bytes; 64 back), then B and C (32 columns, 6,144
    bytes; 16 back: its x columns rank 1 took).  The loss adds four
    all-reduces of (2, 24) (192 bytes).  The heads divide ``model`` (4 of
    16 on zamba2's shared block and Whisper): no other permute."""
    cfg = _cfg(name)
    got = _meta_step(cfg, seq)
    if cfg.family == "encdec":
        # row-parallel outputs: attention and MLP per encoder layer,
        # self, cross and MLP per decoder layer, and the embedding; the
        # gathers: each column-parallel input and the two final norms
        n = 2 * cfg.n_encoder_layers + 3 * cfg.n_layers
        R, F = n + 1, n + 2
        want = {("all-reduce", 192): 4}
    else:
        # a Mamba2 layer and the embedding one each, a shared-block
        # application two (attention, FFN); the final norm's gather
        L = cfg.n_layers
        apps = L // cfg.hybrid_attn_every if cfg.hybrid_attn_every else 0
        R = F = L + 2 * apps + 1
        want = {("all-reduce", 192): 4 + 2 * L,
                ("collective-permute", 12288): 2 * L,
                ("collective-permute", 6144): L,
                ("collective-permute", 3072): L}
    if seq:
        want[("all-gather", 12288)] = want[("reduce-scatter", 6144)] = R + F
    else:
        want[("all-reduce", 12288)] = 2 * R
    assert dict(got) == want, (name, seq, dict(got))


def test_a_q4_leaf_that_does_not_tile_is_kept_whole():
    """zamba2-1.2b W4A16 on an AbstractMesh (16, 16): ``in_proj``'s
    column block (524 of 8,384) is no whole number of 16-column Q4 scale
    groups, so the layout keeps that leaf whole, as ``param_specs`` keeps
    a dim that does not divide: a prefill cell's only all-gathers over
    ``model`` are the 38 layers' ``in_proj`` codes, (2048, 262) a rank,
    once each, and K3 runs the 112 Q4 projections of a forward."""
    from repro_torch.configs import inputs as I
    from repro_torch.configs.base import InputShape
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import (AbstractMesh,
                                                  ParallelContext)
    from repro_torch.launch import dryrun as D

    par = ParallelContext(mesh=AbstractMesh((16, 16), ("data", "model")))
    cell = I.build_cell("zamba2-1.2b", InputShape("prefill_small", 64, 16,
                                                  "prefill"), par,
                        quantized=True)
    calls, kern = [], {}
    with C.record_collectives(calls):
        D.measure(cell, kernels=kern)
    gathers = [s for k, a, s, _ in calls
               if k == "all-gather" and "model" in a]
    assert gathers == [(2048, 262)] * 38, gathers
    assert kern["lut_dequant_matmul"]["calls"] == 112
