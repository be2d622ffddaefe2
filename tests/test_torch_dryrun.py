"""The port's dry-run (``repro_torch.configs.inputs``,
``repro_torch.launch.dryrun``) against the JAX package's, on the CPU.

Checked: for every ``cells()`` cell on the 16x16 and 2x16x16 production
meshes, tp and fsdp layouts, serve cells quantized, the port's
``build_cell`` arguments against the JAX package's ``param_specs``,
``input_specs`` and ``cache_specs`` (every leaf's path, global shape,
dtype, spec and rank-0 block shape; argument bytes equal to the JAX
device's shard bytes, computed from the specs and the mesh, with no
compile); the one-cell CLI of the JAX package's system test, its record's
keys equal to the JAX record's; FLOPs against XLA's ``cost_analysis`` on
small mesh-less cells; each kernel wrapper's ``meta`` rule; and the
collective recorder under an ``AbstractMesh``.
"""
import ast
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs import inputs as JI
from repro.configs.base import SHAPES_BY_NAME as JSHAPES
from repro.configs import registry as JR
from repro.distributed import sharding as JS
from repro.models import api as JAPI
from repro_torch.configs import inputs as I
from repro_torch.configs import registry as R
from repro_torch.configs.base import InputShape
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as S
from repro_torch.kernels import autotune as AT
from repro_torch.kernels import lut_dequant_gemm as K3
from repro_torch.kernels import lut_dequant_kv as K4
from repro_torch.kernels import lut_softmax_attention as K5
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import tile_quantize as K6
from repro_torch.launch import dryrun as D
from repro_torch.quant import tile_quant as TQ
from repro_torch.serving.kv_quant import kv_tile_geometry, quantize_kv

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
STACKED = ("layers", "enc_layers", "dec_layers")


# ---------------------------------------------------------------------------
# the JAX package's specs of a cell, from its own functions
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def jax_tree(arch: str, kind: str):
    """The JAX cell's abstract params: "train" f32 masters, "serve" bf16,
    "q4" bf16 through ``quantize_model_params`` (None where the JAX
    quantizer refuses the config)."""
    cfg = JR.get_config(arch)
    tree = JAPI.get_model(cfg).abstract_params(cfg)
    if kind == "train":
        return tree
    tree = jax.tree.map(lambda a: jax.ShapeDtypeStruct(
        a.shape, jnp.bfloat16 if a.dtype == jnp.float32 else a.dtype), tree)
    if kind == "serve":
        return tree
    from repro.quant.qlinear import quantize_model_params

    try:
        return jax.eval_shape(lambda p: quantize_model_params(p), tree)
    except AssertionError:
        return None


def jax_cell(arch, shape, jpar, quantized):
    """{"params", "pspecs", "opt", "inputs", "cache", "cspecs"} of the JAX
    package's ``build_cell``: its parallel settings, then its own
    ``param_specs``, ``input_specs``, ``cache_specs``, ``abstract_cache``
    and ``init_opt_state`` (no step is traced)."""
    from repro.train.optimizer import init_opt_state

    cfg = JR.get_config(arch)
    cap = shape.seq_len
    if shape.kind == "decode" and cfg.family != "encdec":
        axis = "data" if shape.name == "long_500k" else "model"
        cfg = cfg.with_(kv_partition="sequence")
        jpar = dataclasses.replace(jpar, kv_seq_axis=axis)
        if (cfg.window_size and not cfg.attn_pattern.startswith(
                "local_global") and cfg.window_size < shape.seq_len):
            cfg = cfg.with_(ring_cache=True)
            cap = cfg.window_size
    train = shape.kind == "train"
    jpar = dataclasses.replace(jpar, shard_activations_seq=True) if train \
        else dataclasses.replace(jpar, fsdp=False)
    tree = jax_tree(arch, "train" if train else ("q4" if quantized
                                                  else "serve"))
    out = {"params": tree, "pspecs": JS.param_specs(
        tree, jpar, stacked_prefixes=STACKED),
        "inputs": JI.input_specs(cfg, shape, jpar), "par": jpar}
    if train:
        out["opt"] = jax.eval_shape(init_opt_state, tree)
    if shape.kind == "decode":
        model = JAPI.get_model(cfg)
        B = shape.global_batch
        acache = (model.abstract_cache(cfg, B, shape.seq_len,
                                       t_enc=cfg.encoder_seq_len)
                  if cfg.family == "encdec"
                  else model.abstract_cache(cfg, B, cap))
        out["cache"] = acache
        out["cspecs"] = JI.cache_specs(cfg, jpar, acache, B)
    return out


def norm(spec, ndim):
    """A spec as a tuple of ndim entries, a one-axis tuple as its name."""
    out = []
    for e in tuple(spec) + (None,) * (ndim - len(tuple(spec))):
        if isinstance(e, (tuple, list)):
            e = e[0] if len(e) == 1 else tuple(e)
        out.append(e)
    return tuple(out)


def jax_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in flat}


def port_leaves(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(port_leaves(tree[k], f"{path}/{k}" if path else k))
        return out
    return {path: tree}


def _dtype(d) -> str:
    return str(d).replace("torch.", "")


def shard_bytes(mesh, spec, sds) -> int:
    shard = NamedSharding(mesh, spec).shard_shape(sds.shape)
    return int(np.prod(shard)) * jnp.dtype(sds.dtype).itemsize


def check_tree(what, jtree, jspecs, ptree, pspecs, pblocks, jmesh):
    """Leaf by leaf: path, global shape, dtype, spec, block shape; returns
    the JAX shard bytes."""
    jl, js = jax_leaves(jtree), jax_leaves(jspecs)
    pl, ps, pb = port_leaves(ptree), port_leaves(pspecs), port_leaves(pblocks)
    assert set(jl) == set(pl), (what, set(jl) ^ set(pl))
    total = 0
    for path, sds in jl.items():
        t = pl[path]
        assert tuple(t.shape) == tuple(sds.shape), (what, path)
        assert _dtype(t.dtype) == jnp.dtype(sds.dtype).name, (what, path)
        assert norm(ps[path], t.dim()) == norm(js[path], t.dim()), \
            (what, path, ps[path], js[path])
        shard = NamedSharding(jmesh, js[path]).shard_shape(sds.shape)
        assert tuple(pb[path].shape) == tuple(shard), (what, path)
        total += shard_bytes(jmesh, js[path], sds)
    return total


def _pars(mesh_key, layout):
    shape, names = MESHES[mesh_key]
    tp = layout == "tp"
    return (JS.ParallelContext(mesh=JAbstractMesh(shape, names), tp=tp),
            S.ParallelContext(mesh=S.AbstractMesh(shape, names), tp=tp))


def _arg_bytes(args) -> int:
    return sum(t.numel() * t.element_size()
               for t in port_leaves(dict(enumerate(args))).values()
               if isinstance(t, torch.Tensor))


def _input_names(kind, inputs):
    if kind == "train":
        names = ["tokens", "targets", "mask"]
    elif kind == "prefill":
        names = ["tokens", "lengths"]
    else:
        return {"tokens": 2, "cache_len": 3}
    if "embeddings" in inputs:
        names.append("embeddings")
    return {n: i + (2 if kind == "train" else 1) for i, n in enumerate(names)}


def check_cell(arch, shape, jpar, ppar, quantized):
    """One cell: the port's arguments against the JAX package's specs;
    returns the port's argument bytes."""
    want = jax_cell(arch, shape, jpar, quantized)
    cell = I.build_cell(arch, shape, ppar, quantized=quantized)
    jmesh = jpar.mesh
    total = check_tree("params", want["params"], want["pspecs"],
                       cell.global_args[0], cell.specs[0], cell.args[0],
                       jmesh)
    if shape.kind == "train":
        for part in ("m", "v"):
            total += check_tree(part, want["opt"][part], want["pspecs"],
                                cell.global_args[1][part],
                                cell.specs[1][part], cell.args[1][part],
                                jmesh)
        assert cell.args[1]["step"].dtype == torch.int32
        assert cell.args[1]["step"].shape == ()
        total += 4
    if shape.kind == "decode":
        jc, jcs = want["cache"], want["cspecs"]
        total += check_tree("cache", jc, jcs, cell.global_args[1],
                            cell.specs[1], cell.args[1], jmesh)
    for name, pos in _input_names(shape.kind, want["inputs"]).items():
        sds = want["inputs"][name]
        g, spec, blk = cell.global_args[pos], cell.specs[pos], cell.args[pos]
        assert tuple(g.shape) == tuple(sds.shape), name
        assert _dtype(g.dtype) == jnp.dtype(sds.dtype).name, name
        assert norm(spec, g.dim()) == norm(sds.sharding.spec, g.dim()), \
            (name, spec, sds.sharding.spec)
        assert tuple(blk.shape) == tuple(
            sds.sharding.shard_shape(sds.shape)), name
        total += shard_bytes(jmesh, sds.sharding.spec, sds)
    assert set(_input_names(shape.kind, want["inputs"])) == \
        set(want["inputs"]), (arch, shape.name)
    got = _arg_bytes(cell.args)
    assert got == total, (arch, shape.name, got, total)
    return got


@pytest.mark.parametrize("arch", R.ASSIGNED_ARCHS)
@pytest.mark.parametrize("layout", ["tp", "fsdp"])
@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_cell_arguments_match_jax_specs(arch, layout, mesh_key):
    """Every runnable cell of ``arch``: the serve cells with W4A16 weights
    (where the JAX quantizer refuses the config, as mamba2-130m's N 3352
    in_proj, the port refuses it too and the cell is held in bf16)."""
    jpar, ppar = _pars(mesh_key, layout)
    assert [(a, s.name, ok) for a, s, ok, _ in R.cells([arch])] == \
        [(a, s.name, ok) for a, s, ok, _ in JR.cells([arch])]
    for _, shape, runnable, _ in R.cells([arch]):
        if not runnable:
            continue
        quantized = shape.kind != "train"
        if quantized and jax_tree(arch, "q4") is None:
            with pytest.raises(ValueError, match="tile scheme"):
                I.build_cell(arch, shape, ppar, quantized=True)
            quantized = False
        check_cell(arch, shape, jpar, ppar, quantized)


def test_jax_cell_replica_matches_jax_build_cell():
    """The specs ``jax_cell`` reads from the JAX package's functions are
    its ``build_cell``'s own (checked on a cell of each kind, one with a
    ring cache and one Whisper cell)."""
    jpar, _ = _pars("2x16x16", "tp")
    for arch, name, q in (("gemma3-1b", "train_4k", False),
                          ("olmoe-1b-7b", "prefill_32k", True),
                          ("mixtral-8x7b", "long_500k", True),
                          ("whisper-base", "decode_32k", True)):
        shape = JSHAPES[name]
        cell = JI.build_cell(arch, shape, jpar, quantized=q)
        want = jax_cell(arch, shape, jpar, q)
        trees = [want["params"]]
        specs = [want["pspecs"]]
        if shape.kind == "train":
            trees.append(want["opt"])
            specs.append({"m": want["pspecs"], "v": want["pspecs"],
                          "step": P()})
        if shape.kind == "decode":
            trees.append(want["cache"])
            specs.append(want["cspecs"])
        names = _input_names(shape.kind, want["inputs"])
        for i, (tree, spec_tree) in enumerate(zip(trees, specs)):
            gl, wl = jax_leaves(cell.args[i]), jax_leaves(tree)
            ws = jax_leaves(spec_tree)
            assert set(gl) == set(wl), (arch, name, i)
            for path, sds in gl.items():
                assert sds.shape == wl[path].shape, (arch, path)
                assert sds.dtype == wl[path].dtype, (arch, path)
                assert norm(sds.sharding.spec, len(sds.shape)) == \
                    norm(ws[path], len(sds.shape)), (arch, path)
        for n, pos in names.items():
            assert cell.args[pos].shape == want["inputs"][n].shape
            assert cell.args[pos].sharding.spec == \
                want["inputs"][n].sharding.spec


# ---------------------------------------------------------------------------
# the CLI and the record
# ---------------------------------------------------------------------------


def jax_record_keys() -> tuple:
    """The record keys of the JAX package's ``run_cell`` (read from its
    source: the dict assigned to ``rec`` and its "per_device" dict)."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(getattr(t, "id", None) == "rec" for t in node.targets):
            keys = [k.value for k in node.value.keys]
            inner = node.value.values[keys.index("per_device")]
            return keys, [k.value for k in inner.keys]
    raise AssertionError("no rec = {...} in the JAX dry-run")


def test_dryrun_single_cell_subprocess(tmp_path):
    """The JAX package's system-test cell through the port's CLI: a fresh
    process, 512 devices, on meta with no card visible."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-130m", "--shape", "decode_32k", "--multi-pod", "--out",
         str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rec = json.loads((tmp_path / "mamba2-130m__decode_32k__2x16x16.json")
                     .read_text())
    keys, per_device = jax_record_keys()
    assert list(rec) == keys
    assert list(rec["per_device"]) == per_device
    assert rec["n_devices"] == 512
    assert rec["per_device"]["flops"] > 0
    assert rec["per_device"]["argument_bytes"] > 0
    assert rec["mesh"] == "2x16x16"
    # the serve step moves activations, not weights (the tensor-parallel
    # layout): the regrouped in_proj and conv columns point to point and
    # the row-parallel sums; no all-gather
    assert rec["collectives"]["collective-permute"]["count"] > 0
    assert rec["collectives"]["all-reduce"]["count"] > 0
    assert "all-gather" not in rec["collectives"]


# ---------------------------------------------------------------------------
# FLOPs against XLA on small mesh-less cells
# ---------------------------------------------------------------------------

# XLA's cost analysis counts a while loop's body once, so the JAX layer
# scan and its chunked attention's double scan are compared at one layer
# and sequences inside one attention chunk (q 512, kv 1024), where its
# count is the whole program's.  torch's flop counter counts matrix
# products only; XLA also counts elementwise ops, reductions and
# transcendentals (norms, rope, softmax, SiLU, the loss's one-hot
# contraction, the optimizer update, the sampler's noise).  Measured
# port / XLA on qwen2.5-1.5b-smoke at one layer: train 0.896, prefill
# 0.906, decode 0.706.
FLOP_RATIO = (0.65, 1.0)
SMALL = {"train": (128, 8), "prefill": (128, 4), "decode": (128, 8)}


@pytest.mark.parametrize("kind", list(SMALL))
def test_flops_match_xla_cost_analysis(kind, monkeypatch):
    from repro.configs.base import InputShape as JInputShape
    from repro.distributed.compat import cost_analysis_dict

    arch = "qwen2.5-1.5b"
    jcfg = JR.get_config(arch, smoke=True).with_(n_layers=1)
    pcfg = R.get_config(arch, smoke=True).with_(n_layers=1)
    monkeypatch.setattr(JI, "get_config", lambda a, smoke=False: jcfg)
    monkeypatch.setattr(I, "get_config", lambda a, smoke=False: pcfg)
    S_, B = SMALL[kind]
    name = f"{kind}_small"
    cell = JI.build_cell(arch, JInputShape(name, S_, B, kind),
                         JS.ParallelContext())
    want = cost_analysis_dict(jax.jit(cell.fn).lower(*cell.args)
                              .compile())["flops"]
    got = D.measure(I.build_cell(arch, InputShape(name, S_, B, kind),
                                 S.ParallelContext()))["flops"]
    assert FLOP_RATIO[0] * want <= got <= FLOP_RATIO[1] * want, \
        (kind, got, want, got / want)


def test_mesh_less_decode_counts_the_kernels_and_aliases_the_cache():
    """A W4A16 transformer decode with no mesh: every Q4 projection is one
    hooked K3 call of ``autotune.gemm_cost``, no collective, and the
    updated cache is an output aliased to its argument."""
    cfg = R.get_config("qwen2.5-1.5b")
    shape = InputShape("decode_small", 64, 8, "decode")
    kern = {}
    cell = I.build_cell("qwen2.5-1.5b", shape, S.ParallelContext(),
                        quantized=True)
    m = D.measure(cell, kernels=kern)
    per_layer = 6  # q, k, v, o, gate, up (down is Q8)
    assert kern["lut_dequant_matmul"]["calls"] == per_layer * cfg.n_layers
    hd = cfg.resolved_head_dim()
    want = 0.0
    for K, N in [(cfg.d_model, cfg.n_heads * hd),
                 (cfg.d_model, cfg.n_kv_heads * hd),
                 (cfg.d_model, cfg.n_kv_heads * hd),
                 (cfg.n_heads * hd, cfg.d_model),
                 (cfg.d_model, cfg.d_ff), (cfg.d_model, cfg.d_ff)]:
        want += AT.gemm_cost(8, K, N)[0]
    assert kern["lut_dequant_matmul"]["flops"] == want * cfg.n_layers
    assert m["collectives"] == {}
    cache_bytes = _arg_bytes((cell.args[1],))
    assert m["alias_bytes"] == cache_bytes
    assert m["argument_bytes"] == _arg_bytes(cell.args)
    assert m["flops"] > kern["lut_dequant_matmul"]["flops"]


# ---------------------------------------------------------------------------
# the kernel wrappers' meta rules
# ---------------------------------------------------------------------------


def _meta(tree):
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return tree.to("meta") if isinstance(tree, torch.Tensor) else tree


@pytest.fixture
def no_plain(monkeypatch):
    """The plain versions raise: a meta call must not reach them."""
    def boom(*a, **k):
        raise AssertionError("a plain version ran on meta")

    for mod, name in ((K3, "plain_lut_dequant_gemm"),
                      (K4, "plain_lut_dequant_kv"),
                      (K5, "plain_lut_softmax_attention"),
                      (K6, "plain_tile_quantize"), (PA, "_plain")):
        monkeypatch.setattr(mod, name, boom)


def _hooked(fn):
    seen = []
    prev = ops.set_op_hook(lambda *a: seen.append(a))
    try:
        out = fn()
    finally:
        ops.set_op_hook(prev)
    return out, seen


def _same(meta_out, cpu_out):
    if isinstance(cpu_out, tuple):
        for m, c in zip(meta_out, cpu_out):
            _same(m, c)
        return
    assert meta_out.device.type == "meta"
    assert meta_out.shape == cpu_out.shape and meta_out.dtype == \
        cpu_out.dtype


def test_k3_meta_rule(no_plain):
    gen = torch.Generator().manual_seed(0)
    qw = TQ.quantize(torch.randn((64, 96), generator=gen))
    x = torch.randn((5, 64), generator=gen)
    want = K3.ref.dequant_matmul_ref(x, qw["codes"], qw["scales"],
                                     qw["codebook"])
    got, seen = _hooked(lambda: ops.lut_dequant_matmul(x.to("meta"),
                                                       _meta(qw)))
    _same(got, want)
    assert seen == [("lut_dequant_matmul", *AT.gemm_cost(
        5, 64, 96, x_bytes=4, scale_bytes=qw["scales"].numel() * 2))]
    assert K3.lut_dequant_gemm.launches == 0
    bad = _meta(TQ.quantize(torch.randn((32, 96), generator=gen)))
    with pytest.raises(ValueError, match=r"codes \(32, 48\) do not match x "
                                         r"\(5, 64\) \(need \(K, N/2\)\)"):
        K3.lut_dequant_gemm(x.to("meta"), bad["codes"], bad["scales"],
                            bad["codebook"])


@pytest.mark.parametrize("mode", ["q8", "q4"])
def test_k4_meta_rule_takes_4_byte_rows(no_plain, mode):
    """stablelm-3b's slab (Hkv 32, head_dim 80: 40-byte Q4 rows) is taken
    on meta as on the card; a 2-byte row (q4 head_dim 4) or a 6-byte one
    (q8 head_dim 6) is refused with the card's message."""
    gr, gc = kv_tile_geometry(32, 80)
    q = quantize_kv(torch.randn((7, 32, 80)), mode=mode, gr=gr, gc=gc)
    cb = ops.q4_codebook()
    want = K4.ref.lut_dequant_kv_ref(q["codes"], q["scales"], cb, mode=mode,
                                     gr=gr, gc=gc)
    got, seen = _hooked(lambda: ops.lut_dequant_gather(_meta(q)))
    _same(got, want)
    assert seen == [("lut_dequant_kv", *AT.dequant_kv_cost(
        7, 32, 80, mode, gr=gr, gc=gc))]
    assert K4.lut_dequant_kv.launches == 0
    D_bad = 4 if mode == "q4" else 6
    g2, c2 = kv_tile_geometry(1, D_bad)
    short = _meta(quantize_kv(torch.randn((3, 1, D_bad)), mode=mode, gr=g2,
                              gc=c2))
    dc = D_bad // 2 if mode == "q4" else D_bad
    with pytest.raises(ValueError, match=f"rows of {dc} bytes"):
        K4.lut_dequant_kv(short["codes"], short["scales"], cb.to("meta"),
                          mode=mode, gr=g2, gc=c2)


def _paged_case(kind, Hkv, G, D, B=3, nb=9, bs=16, W=3, gc=None):
    gen = torch.Generator().manual_seed(Hkv * D)
    q = torch.randn((B, Hkv, G, D), generator=gen)
    pools = []
    for _ in range(2):
        fp = torch.randn((nb, bs, Hkv, D), generator=gen) * 0.5
        if kind == "fp":
            pools.append(fp)
        else:
            gr, gc_ = kv_tile_geometry(Hkv, D)
            pools.append(quantize_kv(fp, mode=kind, gr=gr,
                                     gc=gc or gc_))
    table = torch.arange(1, 1 + B * W, dtype=torch.int32).reshape(B, W) % nb
    lens = torch.tensor([W * bs, 5, 17], dtype=torch.int32)
    return q, pools[0], pools[1], table, lens


@pytest.mark.parametrize("kind,Hkv,G,D", [("fp", 2, 3, 32), ("q8", 2, 3, 32),
                                          ("q4", 32, 1, 80),
                                          ("q8", 32, 1, 80),
                                          ("q4", 1, 6, 8)])
def test_k1_k2_meta_rule(no_plain, kind, Hkv, G, D):
    """fp (K1), q8 and q4 (K2) pools, stablelm-3b's 40-byte Q4 rows and
    head_dim 8's 4-byte ones among them: the kernel's output shape and
    dtype, and ``paged_flash_decode``'s hooked cost ``paged_attn_cost``."""
    q, kp, vp, table, lens = _paged_case(kind, Hkv, G, D)
    cb = ops.q4_codebook()
    want = K4.ref.paged_decode_attention_ref(q, kp, vp, table, lens)
    wrapper = PA.paged_attention if kind == "fp" else \
        PA.quant_paged_attention
    extra = () if kind == "fp" else (cb.to("meta"),)
    got = wrapper(q.to("meta"), _meta(kp), _meta(vp), table.to("meta"),
                  lens.to("meta"), None, *extra)
    _same(got, want)
    assert wrapper.launches == 0
    qm = q.reshape(3, 1, Hkv * G, D).to("meta")
    _, seen = _hooked(lambda: ops.paged_flash_decode(
        qm, _meta(kp), _meta(vp), table.to("meta"), lens.to("meta")))
    assert seen == [("paged_flash_decode", *AT.paged_attn_cost(
        3, Hkv * G, 3, 16, D, slab_bytes=ops.pool_slab_bytes(kp),
        q_bytes=4))]


def test_k1_k2_meta_rule_refuses_as_the_card():
    q, kp, vp, table, lens = _paged_case("fp", 2, 3, 12)
    with pytest.raises(ValueError, match="head_dim a multiple of 8 up to "
                                         "256"):
        PA.paged_attention(q.to("meta"), _meta(kp), _meta(vp),
                           table.to("meta"), lens.to("meta"))
    # q4 scale groups of 1 head dim: too narrow for either chunk width
    q, kp, vp, table, lens = _paged_case("q4", 2, 3, 32, gc=1)
    with pytest.raises(ValueError, match="with scale groups of 1 head dims "
                                         "are not taken"):
        PA.quant_paged_attention(q.to("meta"), _meta(kp), _meta(vp),
                                 table.to("meta"), lens.to("meta"), None,
                                 ops.q4_codebook().to("meta"))
    # 4-byte chunks take at most 4 KiB of a KV head's block
    q, kp, vp, table, lens = _paged_case("q8", 1, 1, 40, bs=128, nb=4, W=1)
    with pytest.raises(ValueError, match="at most 4096 bytes of 4-byte "
                                         "chunks"):
        PA.quant_paged_attention(q.to("meta"), _meta(kp), _meta(vp),
                                 table.to("meta"), lens.to("meta"), None,
                                 ops.q4_codebook().to("meta"))


def test_chunk_bytes_keeps_16_byte_rows_on_16_byte_chunks():
    """Rows that took the 16-byte path keep it; narrower quantized rows
    take 4-byte chunks; rows that are not a multiple of 4 bytes none."""
    assert PA.chunk_bytes(256, "fp") == 16          # bf16 head_dim 128
    assert PA.chunk_bytes(128, "q8", 16) == 16      # the main path's q8
    assert PA.chunk_bytes(64, "q4", 16) == 16       # and q4
    assert PA.chunk_bytes(40, "q4", 16) == 4        # stablelm-3b q4
    assert PA.chunk_bytes(80, "q8", 16) == 16       # stablelm-3b q8
    assert PA.chunk_bytes(16, "q4", 4) == 4         # q4 groups of 4 dims
    assert PA.chunk_bytes(16, "q4", 1) == 0
    assert PA.chunk_bytes(6, "q8", 2) == 0
    assert PA.chunk_bytes(8, "fp") == 0


def test_k5_meta_rule(no_plain):
    gen = torch.Generator().manual_seed(1)
    q = torch.randn((2, 64, 4, 32), generator=gen)
    k = torch.randn((2, 64, 2, 32), generator=gen)
    out, seen = _hooked(lambda: ops.flash_attention(
        q.to("meta"), k.to("meta"), k.to("meta"), bq=32, bkv=32))
    assert out.shape == q.shape and out.dtype == q.dtype
    assert seen == [("flash_attention", *AT.attn_cost(8, 64, 64, 32))]
    h = torch.randn((8, 64, 32), dtype=torch.float16)
    want = K5.ref.lut_flash_attention_ref(h, h[:4], h[:4], ops.exp_lut(),
                                          bkv=32, kv_group=2)
    got = K5.lut_softmax_attention(h.to("meta"), h[:4].to("meta"),
                                   h[:4].to("meta"),
                                   ops.exp_lut().to("meta"), bkv=32,
                                   kv_group=2)
    _same(got, want)
    assert K5.lut_softmax_attention.launches == 0
    bad = torch.empty((4, 64, 48), dtype=torch.float16, device="meta")
    with pytest.raises(ValueError, match=r"head_dim \(32, 64, 128\), got "
                                         r"48"):
        K5.lut_softmax_attention(bad, bad, bad, None, exp_mode="exact")


def test_k6_meta_rule(no_plain):
    w = torch.randn((64, 96))
    want = K6.ref.tile_quantize_ref(w)
    got, seen = _hooked(lambda: ops.tile_quantize_op(w.to("meta")))
    _same((got["codes"], got["scales"]), want)
    assert seen == [("tile_quantize", *AT.quantize_cost(
        64, 96, scale_bytes=64 * 96 // 16))]
    assert K6.tile_quantize.launches == 0
    wide = torch.empty((64, 128), device="meta")
    with pytest.raises(ValueError, match="the CUDA kernel takes group_size "
                                         "32, got 64"):
        K6.tile_quantize(wide, group_size=64)


# ---------------------------------------------------------------------------
# the collective recorder
# ---------------------------------------------------------------------------


def test_collectives_under_an_abstract_mesh_are_recorded_not_run():
    """Rank 0's results on meta, counted by result bytes under the HLO
    names, the backward's transposes included; a real tensor raises."""
    mesh = S.AbstractMesh((2, 4), ("data", "model"))
    x = torch.empty((8, 6), device="meta", requires_grad=True)
    with C.record_collectives() as rec:
        g = C.all_gather(x, "model", mesh, dim=0, tiled=True)   # (32, 6)
        s = C.psum_scatter(g, ("data", "model"), mesh, dim=0)   # (4, 6)
        y = C.psum(s, "data", mesh)
        m = C.pmax(y.detach(), "model", mesh)
        y.sum().backward()
        assert C.axis_index(("data", "model"), mesh) == 0
    assert g.shape == (32, 6) and s.shape == (4, 6) and m.shape == (4, 6)
    assert x.grad.shape == x.shape and x.grad.device.type == "meta"
    f = 4  # f32 bytes
    assert rec == {
        "all-gather": {"count": 2, "bytes": (32 * 6 + 32 * 6) * f},
        "reduce-scatter": {"count": 2, "bytes": (4 * 6 + 8 * 6) * f},
        "all-reduce": {"count": 3, "bytes": 3 * 4 * 6 * f}}
    with pytest.raises(ValueError, match="takes meta tensors"):
        C.psum(torch.ones(3), "data", mesh)
    par = S.ParallelContext(mesh=mesh)
    assert S.coordinate(par) == {"data": 0, "model": 0}
