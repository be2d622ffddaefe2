"""The port's distributed layer under multi-process ``gloo`` groups on the
CPU, held against the JAX package on the same numpy inputs.

One launch of 4 ranks (``file://`` init under the test's temp dir, one
thread each, a timeout of its own) runs every case and saves its
results; while it runs, this process computes the JAX references, and
one JAX subprocess with 4 forced host devices runs the reference's
``shard_map`` bodies (``compressed_psum_local``, the sharded
``moe_ffn``).  The cases:

- ``distributed_sample`` on (1, 4) and (2, 2): greedy equals
  ``jnp.argmax`` (the tie rows [7, 0, 40] included), Gumbel frequencies
  match the softmax (chi-square, fixed seed), an odd vocab takes the
  gather path;
- sequence-parallel ``decode_step`` on (4, 1) over "data" (and (2, 2)
  over "model") for ``tiny_cfg``, a local:global windowed config, a ring
  cache and the zamba2 hybrid: f32 logits within 1e-5 of the JAX
  package's dense ``decode_step``; a bf16 cache within ``BF16_ATOL`` of
  it, and its first step within ``BF16_SP_ATOL`` of the JAX package's
  own sequence-parallel decode over the same bf16 cache;
- the MoE's sharded branch on (2, 2), tp and not: y and aux within 1e-5
  of the JAX package's sharded ``moe_ffn``;
- the sharded train step on (2, 2) (and tp=False, microbatches=2,
  ``grad_transform=ef_quantize``, the residual sequence-sharded, a GQA
  config whose q heads split over ``model`` and whose one kv head does
  not) against JAX's single-device ``make_train_step``, and on the MoE
  config (tp and not) against JAX's step under a (2, 2) mesh (the MoE
  routes each token shard on its own), and the zamba2 and Whisper smoke
  configs on their tensor-parallel layouts with the residual
  sequence-sharded against JAX's single-device step: the loss, the grad
  norm, each leaf's finished grad, the params and each leaf's update;
- ``ef_quantize`` on blocks bit-equal to JAX's on the global leaves;
- ``compressed_psum_local`` within one int8 step of JAX's;
- elastic restore onto (2, 2) and (4, 1), bit-equal, from a checkpoint
  of each package;
- ``launch/train.py --mesh 2x1`` against the same run without a mesh.
"""
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
TESTS = str(ROOT / "tests")
WORLD = 4
TIMEOUT = 240          # seconds for a launch of ranks
BF16_ATOL = 1e-2       # sequence-parallel logits over a bf16 cache
# ... and against the JAX package's sequence-parallel decode over the same
# bf16 cache, which rounds the same merge payload to bf16: the first step
# (from the same prefilled cache) within BF16_SP_ATOL (measured 2.3e-7; a
# port that sums the payload in f32 misses by 2.9e-3).  Each step writes
# the new token's K/V, computed from those merges, in bf16, so a payload
# element that rounds the other way in either package moves later steps'
# K/V by a bf16 step: the later steps are held within BF16_ATOL.
BF16_SP_ATOL = 1e-4
# the train step: an update of lr = 1e-3 from the first step on (warmup 1).
# Adam divides each moment by its own magnitude: a grad element within the
# two packages' rounding of zero would become a step of up to lr in an
# arbitrary direction at eps 1e-8; eps 1e-5 damps such elements.
ADAM = dict(lr=1e-3, warmup_steps=1, eps=1e-5)
GRAD_RTOL = 1e-4       # of each leaf's largest |grad| (floored, see below)
NORM_RTOL = 1e-5       # the grad norm
STEP_RTOL = 1e-2       # each leaf's update, of its largest element

# -- shared inputs (both sides build them from these seeds) -----------------

B, PROMPT, STEPS = 4, 7, 5


def tiny(**kw):
    from repro_torch.configs.base import ModelConfig
    base = dict(name="tiny", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=2, d_ff=192, vocab_size=320, dtype="float32",
                param_dtype="float32", remat="none")
    return ModelConfig(**{**base, **kw})


def seqpar_cases():
    """name -> (cfg, max_len, mesh, kv_seq_axis, bf16 cache).  The bf16
    case keeps an f32 model (the CPU has no bf16 logits product) over a
    bf16 cache, whose dtype the merge payload takes."""
    from repro_torch.configs.registry import get_config
    hybrid = get_config("zamba2-1.2b", smoke=True).with_(
        dtype="float32", param_dtype="float32")
    return {
        "tiny": (tiny(), 16, "4x1", "data", False),
        "tiny-model": (tiny(), 16, "2x2", "model", False),
        "window": (tiny(attn_pattern="local_global:1", window_size=5), 16,
                   "4x1", "data", False),
        "ring": (tiny(window_size=8, ring_cache=True), 8, "4x1", "data",
                 False),
        "hybrid": (hybrid, 16, "4x1", "data", False),
        "bf16": (tiny(), 16, "4x1", "data", True),
    }


def seqpar_tokens(cfg):
    rng = np.random.default_rng(3)
    return rng.integers(3, cfg.vocab_size - 3, (B, PROMPT + STEPS))


def train_cfg():
    """``tests/test_distributed.py``'s sharded-step config."""
    return tiny(d_ff=128)


def gqa_cfg():
    """Four q heads of 16 (two a ``model`` rank) over one kv head, whose
    16 columns split 8 and 8: each rank fetches the other's half."""
    return tiny(d_ff=128, n_kv_heads=1)


def train_batch(kind="dense"):
    """(tokens, targets, mask), and frame embeddings for ``encdec``."""
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 320, (8, 32)).astype(np.int32)
    batch = (toks, np.roll(toks, -1, 1), np.ones((8, 32), np.float32))
    if kind == "encdec":
        cfg = variant_cfg(kind)
        batch += (np.random.default_rng(4).standard_normal(
            (8, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32),)
    return batch


# name -> (tp, microbatches, ef_quantize, config, shard_activations_seq);
# every one on (2, 2)
TRAIN_VARIANTS = {"plain": (True, 1, False, "dense", False),
                  "notp": (False, 1, False, "dense", False),
                  "mb2": (True, 2, False, "dense", False),
                  "ef": (True, 1, True, "dense", False),
                  "seq": (True, 1, False, "dense", True),
                  "gqa": (True, 1, False, "gqa", True),
                  "moe": (True, 1, False, "moe", False),
                  "moe-notp": (False, 1, False, "moe", False),
                  "ssm": (True, 1, False, "ssm", True),
                  "encdec": (True, 1, False, "encdec", True)}


def variant_cfg(kind):
    return {"dense": train_cfg, "gqa": gqa_cfg, "moe": moe_cfg,
            "ssm": ssm_cfg, "encdec": encdec_cfg}[kind]()


def ssm_cfg():
    """The zamba2 smoke config (Mamba2 layers, in_proj N 296 split 148 a
    model rank, and the shared attention block), in f32."""
    from repro_torch.configs.registry import get_config
    return get_config("zamba2-1.2b", smoke=True).with_(
        dtype="float32", param_dtype="float32")


def encdec_cfg():
    """The Whisper smoke config (2 heads a model rank), in f32."""
    from repro_torch.configs.registry import get_config
    return get_config("whisper-base", smoke=True).with_(
        dtype="float32", param_dtype="float32")


def moe_cfg():
    from repro_torch.configs.base import MoEConfig
    return tiny(d_model=32, d_ff=0, moe=MoEConfig(n_experts=8, top_k=2,
                                                  expert_d_ff=16))


def moe_inputs():
    from repro_torch.models.moe import init_moe
    cfg = moe_cfg()
    p = init_moe(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    x = np.random.default_rng(2).standard_normal((4, 6, 32)).astype(
        np.float32)
    return cfg, p, x


def sample_inputs():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 64)).astype(np.float32)
    ties = np.full((3, 64), -5.0, np.float32)
    ties[0, [7, 23, 55]] = 2.0
    ties[1, [0, 63]] = 1.0
    ties[2, [40, 41]] = 3.0
    row = (rng.standard_normal(64) * 0.5).astype(np.float32)
    odd = rng.standard_normal((4, 66)).astype(np.float32)
    return np.concatenate([logits, ties]), row, odd


def compress_input(rank):
    return np.random.default_rng(10 + rank).standard_normal(
        (37, 11)).astype(np.float32)


# -- the ranks ---------------------------------------------------------------


def _case_sample(meshes):
    from repro_torch.distributed.sharding import ParallelContext as PC
    from repro_torch.serving.sampler import SamplerConfig, distributed_sample

    logits, row, odd = (torch.from_numpy(a) for a in sample_inputs())
    greedy = SamplerConfig(greedy=True)
    many = row.expand(4096, 64).contiguous()
    return {
        "greedy": distributed_sample(logits, 0, greedy, PC(mesh=meshes["1x4"])),
        "greedy22": distributed_sample(logits[:4], 0, greedy,
                                       PC(mesh=meshes["2x2"])),
        "gumbel": distributed_sample(many, 3, SamplerConfig(temperature=1.0),
                                     PC(mesh=meshes["1x4"])),
        "odd": distributed_sample(odd, 0, greedy,
                                  PC(mesh=meshes["1x4"])),
    }


def _case_seqpar(meshes):
    from repro_torch.distributed.sharding import ParallelContext as PC
    from repro_torch.models import api
    from repro_torch.serving import seq_parallel as SP

    out = {}
    for name, (cfg, max_len, mesh, axis, bf16) in seqpar_cases().items():
        m = api.get_model(cfg)
        p = m.init_params(cfg, seed=0, device="cpu")
        toks = torch.from_numpy(seqpar_tokens(cfg))
        par = PC(mesh=meshes[mesh], kv_seq_axis=axis, fsdp=False)
        cache = m.init_cache(cfg, B, max_len, device="cpu",
                             dtype=torch.bfloat16 if bf16 else None)
        lens = torch.full((B,), PROMPT, dtype=torch.int32)
        with torch.no_grad():
            m.prefill(p, toks[:, :PROMPT], cfg, lengths=lens, cache=cache)
            local = SP.shard_cache(cache, par, B)
            out[name] = torch.stack([
                m.decode_step(p, toks[:, t:t + 1], local,
                              torch.full((B,), t + 1, dtype=torch.int32),
                              cfg, par) for t in range(PROMPT, PROMPT + STEPS)])
    return out


def _case_moe(meshes):
    from repro_torch.distributed.sharding import ParallelContext as PC
    from repro_torch.distributed.sharding import gather_leaf, shard_of
    from repro_torch.models.moe import moe_ffn

    cfg, p, x = moe_inputs()
    x = torch.from_numpy(x)
    out = {}
    for tp in (True, False):
        par = PC(mesh=meshes["2x2"], tp=tp)
        y, aux = moe_ffn(p, x, cfg, par)
        out[f"tp{int(tp)}"] = (y, aux)
        # the same call on rows already split over every axis (the train
        # step's layout under tp=False): regrouped to the reference's
        rows = ("data", "model")
        yl, auxl = moe_ffn(p, shard_of(x, (rows,), par), cfg, par,
                           row_axes=rows)
        out[f"tp{int(tp)}-rows"] = (gather_leaf(yl, (rows,), par), auxl)
    return out


def _case_train(meshes):
    from repro_torch.distributed.compression import ef_quantize
    from repro_torch.distributed.sharding import ParallelContext as PC
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.models import api
    from repro_torch.train import loop as TL
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state

    out = {}
    for name, (tp, mb, ef, kind, seq) in TRAIN_VARIANTS.items():
        batch = tuple(torch.from_numpy(a) for a in train_batch(kind))
        cfg = variant_cfg(kind)
        par = PC(mesh=meshes["2x2"], tp=tp, shard_activations_seq=seq)
        blocks, specs = TL.shard_params(
            api.get_model(cfg).init_params(cfg, seed=0, device="cpu"), par)
        seen = {}

        def gt(g, specs=specs, par=par, ef=ef, seen=seen):
            seen["grads"] = g  # the finished grads, before any transform
            return ef_quantize(g, specs=specs, par=par)[0] if ef else g

        step = TL.make_train_step(cfg, AdamWConfig(**ADAM), par,
                                  microbatches=mb, grad_transform=gt,
                                  specs=specs)
        blocks, opt, met = step(blocks, init_opt_state(blocks), batch)
        out[name] = {"params": gather_tree(blocks, specs, par),
                     "grads": gather_tree(seen["grads"], specs, par),
                     "loss": met["loss"], "grad_norm": met["grad_norm"],
                     "rank_bytes": sum(b.numel() * b.element_size() for b in
                                       _leaves(blocks))}
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _case_ef(meshes):
    from repro_torch.distributed.compression import ef_quantize
    from repro_torch.distributed.sharding import (ParallelContext as PC,
                                                  gather_tree, param_specs,
                                                  shard_tree)

    g, e = ef_inputs()
    par = PC(mesh=meshes["2x2"])
    specs = param_specs(g, par)
    comp, new_ef = ef_quantize(shard_tree(g, specs, par),
                               shard_tree(e, specs, par), specs=specs,
                               par=par)
    return {"comp": gather_tree(comp, specs, par),
            "ef": gather_tree(new_ef, specs, par)}


def ef_inputs():
    """A grad-shaped tree (the train config's, JAX layout) and an error
    state, as tensors."""
    from repro_torch.distributed.sharding import stack_layers
    from repro_torch.models import api

    cfg = train_cfg()
    shapes = stack_layers(api.abstract_params(cfg))
    rng = np.random.default_rng(4)

    def fill(node, scale):
        if isinstance(node, dict):
            return {k: fill(v, scale) for k, v in node.items()}
        return torch.from_numpy((rng.standard_normal(tuple(node.shape))
                                 * scale).astype(np.float32))

    return fill(shapes, 1.0), fill(shapes, 0.01)


def _case_compress(meshes):
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.compression import compressed_psum_local

    mesh = meshes["4x1"]
    x = torch.from_numpy(compress_input(C.axis_index("data", mesh)))
    return {"got": compressed_psum_local(x, "data", mesh),
            "bf16": compressed_psum_local(x, "data", mesh,
                                          rs_dtype=torch.bfloat16),
            "psum": C.psum(x, "data", mesh)}


def _case_elastic(meshes, out_dir):
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.distributed.elastic import elastic_restore, remesh
    from repro_torch.distributed.sharding import (ParallelContext as PC,
                                                  param_specs, shard_of,
                                                  stack_layers)
    from repro_torch.models import api

    template = stack_layers(api.abstract_params(train_cfg()))
    glob = dict(np.load(out_dir / "global.npz"))
    out = {}
    for src in ("port", "jax"):
        ck = Checkpointer(str(out_dir / f"ck_{src}"))
        whole, step = elastic_restore(ck, template, PC(), device="cpu")
        ok = step == 5 and all(
            torch.equal(t, torch.from_numpy(glob[k]))
            for k, t in _paths(whole))
        for mesh in ("2x2", "4x1"):
            par = PC(mesh=meshes[mesh])
            blocks, step = elastic_restore(ck, template, par, device="cpu")
            specs = dict(_paths(param_specs(template, par)))
            live = dict(_paths(remesh(whole, par)))
            for k, t in _paths(blocks):
                want = shard_of(torch.from_numpy(glob[k]), specs[k], par)
                ok &= torch.equal(t, want) and torch.equal(live[k], want)
            ok &= step == 5
        out[src] = ok
    return out


def _paths(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{path}/{k}" if path else k)
    else:
        yield path, tree


def _rank_main():
    """One rank: every case, its results saved as ``rank<r>.pt``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_host_mesh

    torch.set_num_threads(1)
    out_dir = Path(os.environ["REPRO_TEST_OUT"])
    rank, _ = init_distributed("gloo", init_method=os.environ["REPRO_INIT"])
    meshes = {"4x1": make_host_mesh(4, 1), "2x2": make_host_mesh(2, 2),
              "1x4": make_host_mesh(1, 4)}
    res, times = {}, {}
    for name, fn in (("sample", _case_sample), ("seqpar", _case_seqpar),
                     ("moe", _case_moe), ("train", _case_train),
                     ("ef", _case_ef), ("compress", _case_compress)):
        t0 = time.perf_counter()
        res[name] = fn(meshes)
        times[name] = time.perf_counter() - t0
    res["elastic"] = _case_elastic(meshes, out_dir)
    res["times"] = times
    torch.save(res, out_dir / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


# -- launching ---------------------------------------------------------------


def start_ranks(n, argv, out_dir, env=None):
    """Start ``n`` ranks of ``argv`` (RANK / WORLD_SIZE / LOCAL_RANK set),
    output to ``out_dir/log<r>.txt``."""
    procs = []
    for r in range(n):
        e = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, TESTS]),
                 RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                 OMP_NUM_THREADS="1", **(env or {}))
        log = open(out_dir / f"log{r}.txt", "w")
        procs.append((subprocess.Popen(argv, env=e, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    return procs


def wait_ranks(procs, out_dir, timeout=TIMEOUT):
    """Wait for every rank; on the timeout kill them all.  Fails unless
    every rank exited 0."""
    deadline = time.monotonic() + timeout
    codes = []
    for p, log in procs:
        try:
            codes.append(p.wait(timeout=max(1.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            for q, _ in procs:
                q.kill()
            codes.append("timeout")
        log.close()
    if any(c != 0 for c in codes):
        logs = "\n".join((out_dir / f"log{r}.txt").read_text()[-3000:]
                         for r in range(len(procs)))
        pytest.fail(f"ranks exited {codes}:\n{logs}")


JAX_SCRIPT = textwrap.dedent("""
    import json, sys, numpy as np, jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.configs.base import ModelConfig, MoEConfig
    from repro.distributed.compat import shard_map
    from repro.distributed.compression import compressed_psum_local
    from repro.distributed.sharding import ParallelContext
    from repro.launch.mesh import make_host_mesh
    from repro.models import api
    from repro.models.moe import moe_ffn
    from repro.train.loop import make_train_step
    from repro.train.optimizer import AdamWConfig, init_opt_state
    d = dict(np.load(sys.argv[1]))
    meta = json.loads(open(sys.argv[3]).read())
    out = {}

    def config(c):
        c = dict(c)
        if c["moe"]:
            c["moe"] = MoEConfig(**c["moe"])
        return ModelConfig(**c)

    def tree(prefix):
        root = {}
        for k, v in d.items():
            if k.startswith(prefix + "/"):
                *keys, last = k[len(prefix) + 1:].split("/")
                node = root
                for key in keys:
                    node = node.setdefault(key, {})
                node[last] = jnp.asarray(v)
        return root

    def flat(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                flat(v, prefix + "/" + k)
        else:
            out[prefix] = np.asarray(t)

    mesh = jax.make_mesh((4,), ("pod",))
    for key, dt in (("got", jnp.float32), ("bf16", jnp.bfloat16)):
        fn = shard_map(lambda v: compressed_psum_local(v[0], "pod",
                                                       rs_dtype=dt),
                       mesh=mesh, in_specs=(P("pod"),), out_specs=P(),
                       check_vma=False)
        out[key] = np.asarray(fn(jnp.asarray(d["compress"])))
    cfg = config(meta["moe"])
    p = {"router": {"w": d["router"]},
         "experts": {k: d[k] for k in ("gate", "up", "down")}}
    mesh = make_host_mesh(2, 2)
    for tp in (True, False):
        y, aux = moe_ffn(p, jnp.asarray(d["x"]), cfg,
                         ParallelContext(mesh=mesh, tp=tp))
        out[f"y{int(tp)}"], out[f"aux{int(tp)}"] = np.asarray(y), np.asarray(aux)

    # sequence-parallel decode over a bf16 cache, teacher-forced
    cfg = config(meta["bf16"])
    m, sp = api.get_model(cfg), tree("sp")
    toks = jnp.asarray(d["sp_toks"], jnp.int32)
    B, n0, n = meta["rows"], meta["prompt"], meta["steps"]
    _, cache = jax.jit(lambda p, t: m.prefill(p, t, cfg,
                                              max_len=meta["max_len"]))(
        sp, toks[:, :n0])
    cache = jax.tree.map(lambda a: a.astype(jnp.bfloat16), cache)
    par = ParallelContext(mesh=make_host_mesh(4, 1), kv_seq_axis="data",
                          fsdp=False)
    step = jax.jit(lambda p, t, c, k: m.decode_step(p, t, c, k, cfg, par))
    lgs = []
    for t in range(n0, n0 + n):
        lg, cache = step(sp, toks[:, t:t + 1], cache,
                         jnp.full((B,), t + 1, jnp.int32))
        lgs.append(np.asarray(lg, np.float32))
    out["seqpar_bf16"] = np.stack(lgs)

    # the MoE config's train step under the (2, 2) mesh, jitted with the
    # finished grads its grad transform sees as a further output
    cfg = config(meta["moe"])
    mp = tree("moe")
    batch = tuple(jnp.asarray(d[k]) for k in ("tokens", "targets", "mask"))
    for tp in (True, False):
        def run(p, o, b, tp=tp):
            seen = {}

            def keep(g):
                seen["g"] = g
                return g

            step = make_train_step(cfg, AdamWConfig(**meta["adam"]),
                                   ParallelContext(mesh=mesh, tp=tp),
                                   grad_transform=keep)
            newp, _, met = step(p, o, b)
            return newp, met, seen["g"]

        newp, met, grads = jax.jit(run)(mp, init_opt_state(mp), batch)
        key = "moe" if tp else "moe-notp"
        flat(newp, key + "/params")
        flat(grads, key + "/grads")
        out[key + "/loss"] = np.asarray(met["loss"])
        out[key + "/grad_norm"] = np.asarray(met["grad_norm"])
    np.savez(sys.argv[2], **out)
""")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Start the ranks and the JAX subprocess, then compute the in-process
    JAX references while they run; returns (rank results, JAX shard_map
    results, references)."""
    import dataclasses

    from repro_torch import bridge
    from repro_torch.models import api

    out = tmp_path_factory.mktemp("dist")
    _write_checkpoints(out)
    procs = start_ranks(
        WORLD, [sys.executable, "-c",
                "import test_torch_distributed as t; t._rank_main()"], out,
        env={"REPRO_TEST_OUT": str(out),
             "REPRO_INIT": f"file://{out / 'pg'}"})
    cfg, p, x = moe_inputs()
    sp_cfg = seqpar_cases()["bf16"][0]
    arrays = dict(
        x=x, router=p["router"]["w"].numpy(),
        compress=np.stack([compress_input(r) for r in range(WORLD)]),
        sp_toks=seqpar_tokens(sp_cfg),
        **dict(zip(("tokens", "targets", "mask"), train_batch())),
        **{k: v.numpy() for k, v in p["experts"].items()})
    for prefix, c in (("sp", sp_cfg), ("moe", moe_cfg())):
        init = api.get_model(c).init_params(c, seed=0, device="cpu")
        arrays.update({f"{prefix}/{k}": v for k, v in
                       _paths(bridge.params_to_jax(init))})
    np.savez(out / "jax_in.npz", **arrays)
    (out / "jax_meta.json").write_text(json.dumps(dict(
        moe=dataclasses.asdict(moe_cfg()), bf16=dataclasses.asdict(sp_cfg),
        rows=B, prompt=PROMPT, steps=STEPS, max_len=seqpar_cases()["bf16"][1],
        adam=ADAM)))
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jproc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT,
                              str(out / "jax_in.npz"),
                              str(out / "jax_out.npz"),
                              str(out / "jax_meta.json")], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
    try:
        refs = {"seqpar": _jax_seqpar_refs(), "train": _jax_train_refs()}
    finally:
        wait_ranks(procs, out)
        jout, _ = jproc.communicate(timeout=TIMEOUT)
    assert jproc.returncode == 0, jout[-3000:]
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    jax_out = dict(np.load(out / "jax_out.npz"))
    for key in ("moe", "moe-notp"):
        refs["train"][key] = {
            "init": {k[4:]: v for k, v in arrays.items()
                     if k.startswith("moe/")},
            **{part: {k[len(key) + len(part) + 2:]: v
                      for k, v in jax_out.items()
                      if k.startswith(f"{key}/{part}/")}
               for part in ("params", "grads")},
            "loss": float(jax_out[f"{key}/loss"]),
            "grad_norm": float(jax_out[f"{key}/grad_norm"])}
    return ranks, jax_out, refs


def _write_checkpoints(out):
    """The train config's params, seed 0: the global arrays (npz) and a
    checkpoint of each package at step 5."""
    import jax.numpy as jnp

    from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
    from repro_torch import bridge
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.distributed.sharding import stack_layers
    from repro_torch.models import api

    cfg = train_cfg()
    p = api.get_model(cfg).init_params(cfg, seed=0, device="cpu")
    np.savez(out / "global.npz", **dict(_paths(bridge.params_to_jax(p))))
    Checkpointer(str(out / "ck_port")).save(stack_layers(p), step=5)
    host = bridge.params_to_jax(p)
    import jax
    JCheckpointer(str(out / "ck_jax")).save(
        jax.tree.map(jnp.asarray, host), step=5)


def _jax_cfg(cfg):
    import dataclasses

    from repro.configs.base import ModelConfig as JMC
    from repro.configs.base import MoEConfig as JMoE
    from repro.configs.base import SSMConfig as JSSM
    d = dataclasses.asdict(cfg)
    if cfg.moe:
        d["moe"] = JMoE(**d["moe"])
    if cfg.ssm:
        d["ssm"] = JSSM(**d["ssm"])
    return JMC(**d)


def _jax_params(cfg):
    import jax.numpy as jnp

    import jax
    from repro_torch import bridge
    from repro_torch.models import api

    p = api.get_model(cfg).init_params(cfg, seed=0, device="cpu")
    return jax.tree.map(jnp.asarray, bridge.params_to_jax(p))


def _jax_seqpar_refs():
    """The JAX package's dense decode, teacher-forced over the same
    tokens: (STEPS, B, V) logits per case."""
    import jax
    import jax.numpy as jnp

    from repro.models import api as JAPI

    refs = {}
    for name, (cfg, max_len, _, _, bf16) in seqpar_cases().items():
        jcfg = _jax_cfg(cfg)
        m = JAPI.get_model(jcfg)
        p = _jax_params(cfg)
        toks = jnp.asarray(seqpar_tokens(cfg), jnp.int32)
        _, cache = jax.jit(lambda p, t: m.prefill(p, t, jcfg,
                                                  max_len=max_len))(
            p, toks[:, :PROMPT])
        if bf16:
            cache = jax.tree.map(lambda a: a.astype(jnp.bfloat16), cache)
        step = jax.jit(lambda p, t, c, n: m.decode_step(p, t, c, n, jcfg))
        out = []
        for t in range(PROMPT, PROMPT + STEPS):
            lg, cache = step(p, toks[:, t:t + 1], cache,
                             jnp.full((B,), t + 1, jnp.int32))
            out.append(np.asarray(lg, np.float32))
        refs[name] = np.stack(out)
    return refs


def _jax_train_refs():
    """JAX's single-device step per dense variant, jitted with the
    finished grads its grad transform sees as a further output: {"init",
    "params", "grads" (path -> array), "loss", "grad_norm"}."""
    import jax
    import jax.numpy as jnp

    from repro.distributed.compression import ef_quantize
    from repro.train.loop import make_train_step
    from repro.train.optimizer import AdamWConfig, init_opt_state

    refs = {}
    for name, (tp, mb, ef, kind, seq) in TRAIN_VARIANTS.items():
        batch = tuple(jnp.asarray(a) for a in train_batch(kind))
        if kind == "moe":
            continue  # JAX's step under a mesh, in the JAX subprocess
        if (not tp or seq) and kind == "dense":
            # one device has no model axis and no sequence split
            refs[name] = refs["plain"]
            continue
        cfg = variant_cfg(kind)
        jcfg = _jax_cfg(cfg)
        p = _jax_params(cfg)
        init = dict(_paths(jax.tree.map(np.asarray, p)))

        def run(p, o, b, mb=mb, ef=ef, jcfg=jcfg):
            seen = {}

            def gt(g):
                seen["g"] = g
                return ef_quantize(g)[0] if ef else g

            step = make_train_step(jcfg, AdamWConfig(**ADAM), None,
                                   microbatches=mb, grad_transform=gt)
            newp, _, met = step(p, o, b)
            return newp, met, seen["g"]

        newp, met, grads = jax.jit(run)(p, init_opt_state(p), batch)
        refs[name] = {"init": init,
                      "params": dict(_paths(jax.tree.map(np.asarray, newp))),
                      "grads": dict(_paths(jax.tree.map(np.asarray, grads))),
                      "loss": float(met["loss"]),
                      "grad_norm": float(met["grad_norm"])}
    return refs


# -- the tests ---------------------------------------------------------------


def test_distributed_sample_greedy_matches_argmax(run):
    import jax.numpy as jnp

    ranks, _, _ = run
    logits, _, odd = sample_inputs()
    want = np.asarray(jnp.argmax(jnp.asarray(logits), -1))
    for r in ranks:
        np.testing.assert_array_equal(r["sample"]["greedy"].numpy(), want)
        np.testing.assert_array_equal(r["sample"]["greedy22"].numpy(),
                                      want[:4])
        np.testing.assert_array_equal(r["sample"]["odd"].numpy(),
                                      np.asarray(jnp.argmax(odd, -1)))
    np.testing.assert_array_equal(ranks[0]["sample"]["greedy"][4:].numpy(),
                                  [7, 0, 40])


def test_distributed_sample_gumbel_follows_the_softmax(run):
    """4096 draws from one row (4 shards of 16): the chi-square statistic
    of the token counts against the softmax under 103.44, the 0.999
    quantile of 63 degrees of freedom; every rank draws the same tokens."""
    import jax

    ranks, _, _ = run
    _, row, _ = sample_inputs()
    tok = ranks[0]["sample"]["gumbel"].numpy()
    assert all(np.array_equal(r["sample"]["gumbel"].numpy(), tok)
               for r in ranks)
    probs = np.asarray(jax.nn.softmax(row))
    counts = np.bincount(tok, minlength=64)
    expect = probs * len(tok)
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < 103.44, chi2


@pytest.mark.parametrize("case", list(seqpar_cases()))
def test_seq_parallel_decode_matches_jax_dense_decode(run, case):
    ranks, jout, refs = run
    want = refs["seqpar"][case]
    atol = BF16_ATOL if case == "bf16" else 1e-5
    for r in ranks:
        got = r["seqpar"][case].float().numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=atol, rtol=0)
        if case == "bf16":
            np.testing.assert_allclose(got[0], jout["seqpar_bf16"][0],
                                       atol=BF16_SP_ATOL, rtol=0)
            np.testing.assert_allclose(got, jout["seqpar_bf16"],
                                       atol=BF16_ATOL, rtol=0)


def test_seq_parallel_refuses_a_paged_cache():
    from repro_torch.distributed.sharding import AbstractMesh, ParallelContext
    from repro_torch.models import transformer

    cfg = tiny()
    p = transformer.init_params(cfg, seed=0, device="cpu")
    par = ParallelContext(mesh=AbstractMesh((4, 1), ("data", "model")),
                          kv_seq_axis="data")
    cache = transformer.init_paged_cache(cfg, 4, 8, device="cpu")
    cache["table"] = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="paged"):
        transformer.decode_step(p, torch.zeros((1, 1), dtype=torch.long),
                                cache, torch.ones(1, dtype=torch.int32), cfg,
                                par)


@pytest.mark.parametrize("tp", [True, False])
def test_moe_sharded_branch_matches_jax(run, tp):
    ranks, jout, _ = run
    for r in ranks:
        for key in (f"tp{int(tp)}", f"tp{int(tp)}-rows"):
            y, aux = r["moe"][key]
            np.testing.assert_allclose(y.numpy(), jout[f"y{int(tp)}"],
                                       atol=1e-5, rtol=0)
            assert abs(float(aux) - float(jout[f"aux{int(tp)}"])) < 1e-5


@pytest.mark.parametrize("variant", list(TRAIN_VARIANTS))
def test_sharded_train_step_matches_jax_single_device(run, variant):
    """One step from the same params and batch: the loss within 1e-4;
    the grad norm within ``NORM_RTOL``; each leaf's finished grad (before
    ``ef_quantize``) within ``GRAD_RTOL`` of its largest element, floored
    at 1e-3 of the tree's largest (a leaf that is zero in exact arithmetic
    holds only rounding); the params within 1e-4; and each leaf's update
    (new minus old, about lr = 1e-3 an element) within ``STEP_RTOL`` of
    its largest, which an unchanged leaf fails.  A leaf whose grad is zero
    in exact arithmetic (Whisper's ``wk`` bias: a shift of every key by
    the same vector adds q.b to a row's scores, which the softmax drops)
    has a reference grad within f32 rounding of zero (at most 1e-6 of the
    tree's largest), which Adam turns into a step in an arbitrary
    direction: its grad is held by the grad check and its update is not
    compared.  The MoE variants hold against JAX's step under the same
    (2, 2) mesh."""
    ranks, _, refs = run
    want = refs["train"][variant]
    top = max(float(np.abs(g).max()) for g in want["grads"].values())
    for r in ranks:
        res = r["train"][variant]
        assert abs(float(res["loss"]) - want["loss"]) < 1e-4
        norm = float(res["grad_norm"])
        assert abs(norm - want["grad_norm"]) <= NORM_RTOL * want[
            "grad_norm"], (variant, norm, want["grad_norm"])
        grads = dict(_paths(res["grads"]))
        got = dict(_paths(res["params"]))
        assert sorted(got) == sorted(want["params"]) == sorted(grads)
        for k, g in grads.items():
            w = want["grads"][k]
            scale = max(float(np.abs(w).max()), 1e-3 * top)
            err = float(np.abs(g.numpy() - w).max())
            assert err <= GRAD_RTOL * scale, (variant, k, err, scale)
        for k, t in got.items():
            new = t.numpy()
            assert float(np.abs(new - want["params"][k]).max()) < 1e-4, k
            if float(np.abs(want["grads"][k]).max()) <= 1e-6 * top:
                continue  # zero in exact arithmetic: rounding, normalized
            step = new - want["init"][k]
            ref = want["params"][k] - want["init"][k]
            err = float(np.abs(step - ref).max())
            assert err <= STEP_RTOL * float(np.abs(ref).max()), (
                variant, k, err, float(np.abs(ref).max()))


def test_sharded_train_state_is_the_rank_block_bytes(run):
    """Each rank stores its blocks of ``param_specs``: on (2, 2) a quarter
    of every leaf the rules shard both ways, and in all the bytes the
    rules give."""
    from repro_torch.distributed.sharding import (AbstractMesh,
                                                  ParallelContext,
                                                  param_specs, stack_layers,
                                                  tree_bytes)
    from repro_torch.models import api

    ranks, _, _ = run
    tree = stack_layers(api.abstract_params(train_cfg()))
    par = ParallelContext(mesh=AbstractMesh((2, 2), ("data", "model")))
    want = tree_bytes(tree, param_specs(tree, par), par)
    full = tree_bytes(tree, param_specs(tree, ParallelContext()),
                      ParallelContext())
    for r in ranks:
        assert r["train"]["plain"]["rank_bytes"] == want < full


def test_ef_quantize_matches_jax_bit_for_bit(run):
    """Blocks through the sharded ``ef_quantize`` (each leaf's absmax over
    its global leaf) and a whole tree through the port's, against the JAX
    package's on the global leaves, with and without an error state."""
    import jax
    import jax.numpy as jnp

    from repro.distributed.compression import ef_quantize as jef
    from repro_torch.distributed.compression import ef_quantize

    ranks, _, _ = run
    g, e = ef_inputs()
    jg = jax.tree.map(lambda t: jnp.asarray(t.numpy()), g)
    je = jax.tree.map(lambda t: jnp.asarray(t.numpy()), e)
    jc, jn = jef(jg, je)
    jc0, _ = jef(jg)
    want_c, want_n = dict(_paths(jc)), dict(_paths(jn))
    pc, pn = ef_quantize(g, e)
    pc0, none = ef_quantize(g)
    assert none is None
    for k, t in _paths(pc0):
        np.testing.assert_array_equal(t.numpy(), np.asarray(dict(
            _paths(jc0))[k]))
    for got_c, got_n in [(pc, pn)] + [(r["ef"]["comp"], r["ef"]["ef"])
                                      for r in ranks]:
        for k, t in _paths(got_c):
            np.testing.assert_array_equal(t.numpy(), np.asarray(want_c[k]))
        for k, t in _paths(got_n):
            np.testing.assert_array_equal(t.numpy(), np.asarray(want_n[k]))


@pytest.mark.parametrize("key", ["got", "bf16"])
def test_compressed_psum_local_matches_jax(run, key):
    """Within one int8 step (the largest shard scale) of the JAX package's
    under 4 forced host devices (with a bf16 reduce-scatter, plus one bf16
    rounding of the largest sum: the two sum in different orders), and
    within its 2e-2 bound of the sum."""
    ranks, jout, _ = run
    total = sum(compress_input(r) for r in range(WORLD)).reshape(-1)
    pad = (-total.size) % WORLD
    shards = np.pad(total, (0, pad)).reshape(WORLD, -1)
    step = float(np.abs(shards).max(1).max() / 127.0)
    if key == "bf16":
        step += 2.0 ** (np.floor(np.log2(np.abs(total).max())) - 7)
    for r in ranks:
        got = r["compress"][key].float().numpy()
        np.testing.assert_allclose(got, jout[key].astype(np.float32),
                                   atol=step * 1.01, rtol=0)
        psum = r["compress"]["psum"].numpy()
        assert np.abs(got - psum).max() / np.abs(psum).max() < 2e-2
    assert np.array_equal(ranks[0]["compress"]["got"].numpy(),
                          ranks[3]["compress"]["got"].numpy())


@pytest.mark.parametrize("src", ["port", "jax"])
def test_elastic_restore_is_bit_equal_on_any_mesh(run, src):
    ranks, _, _ = run
    assert all(r["elastic"][src] for r in ranks)


def test_train_entry_point_mesh_matches_one_device(tmp_path):
    """``launch/train.py --mesh 2x1`` (2 ranks, gloo, ``file://`` init)
    prints the losses of the run without a mesh, and saves a checkpoint
    whose blocks for each rank, cut from it restored whole, hash to the
    digest that rank printed of its trained state after the save."""
    import re

    from repro_torch import tree as T
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.distributed.elastic import elastic_restore
    from repro_torch.distributed.sharding import (AbstractMesh,
                                                  ParallelContext,
                                                  param_specs, shard_of,
                                                  stack_layers)
    from repro_torch.launch import train
    from repro_torch.models import api
    from repro_torch.train.loop import state_specs
    from repro_torch.train.optimizer import init_opt_state

    args = ["--arch", "qwen2.5-1.5b", "--smoke", "--device", "cpu",
            "--steps", "2", "--batch", "4", "--seq", "32", "--log-every",
            "1"]
    procs = start_ranks(2, [sys.executable, "-m", "repro_torch.launch.train",
                            "--mesh", "2x1", "--backend", "gloo",
                            "--dist-init", f"file://{tmp_path / 'pg'}",
                            "--ckpt-dir", str(tmp_path / "ck")] + args,
                        tmp_path)
    one = train.main(args)
    wait_ranks(procs, tmp_path)
    log = (tmp_path / "log0.txt").read_text()
    losses = [float(line.split()[3]) for line in log.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 2, log
    for a, b in zip(losses, one["losses"]):
        assert abs(a - b) < 2e-4, (losses, one["losses"])
    assert not any(line.startswith("step ") for line in
                   (tmp_path / "log1.txt").read_text().splitlines())
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_00000002"]
    manifest = json.loads((tmp_path / "ck" / "step_00000002" /
                           "manifest.json").read_text())
    assert manifest["step"] == 2
    abstract = stack_layers(api.abstract_params(one["cfg"]))
    template = {"params": abstract, "opt": init_opt_state(abstract),
                "step": torch.zeros((), dtype=torch.int32, device="meta")}
    whole, step = elastic_restore(Checkpointer(str(tmp_path / "ck")),
                                  template, ParallelContext(), device="cpu")
    assert step == 2
    par = ParallelContext(mesh=AbstractMesh((2, 1), ("data", "model")))
    leaves, tspec = T.flatten(whole)
    specs = [s for _, s in _paths(state_specs(param_specs(abstract, par)))]
    for r in range(2):
        printed = re.findall(r"state sha256 ([0-9a-f]{64})",
                             (tmp_path / f"log{r}.txt").read_text())
        cut = T.unflatten(tspec, [
            shard_of(w, s, par, coord={"data": r, "model": 0})
            for w, s in zip(leaves, specs)])
        assert printed == [T.digest(cut)], r


def test_train_entry_point_refuses_a_mismatched_world(tmp_path, monkeypatch):
    import torch.distributed as dist

    from repro_torch.launch import train

    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    try:
        with pytest.raises(SystemExit, match="needs 4 ranks"):
            train.main(["--arch", "qwen2.5-1.5b", "--smoke", "--device",
                        "cpu", "--steps", "1", "--mesh", "2x2", "--backend",
                        "gloo", "--dist-init", f"file://{tmp_path / 'pg'}"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with pytest.raises(SystemExit, match="DxM"):
        train.parse_mesh("2y2")
