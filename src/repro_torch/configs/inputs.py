"""Per-(arch x shape) input specs and step builders for the dry-run.

``input_specs`` gives, for every model input, its global shape, dtype and
spec over the mesh axes (a tuple per dim, as ``param_specs`` gives them);
``cache_specs`` the specs of a decode cache; ``build_cell`` the step
function of one dry-run cell with its arguments:

  train_*   -> the sharded train step (fwd + bwd + AdamW update)
  prefill_* -> prefill (prompt forward + KV-cache build)
  decode_* / long_* -> serve step (one decode step + distributed sampling)

The cells, their parallel settings and their specs are the JAX
package's (``repro.configs.inputs``).  What runs under them is the port's
own layout: a cell's arguments (``Cell.args``) are ``meta`` tensors of
rank 0's blocks of the global inputs (``sharding.local_shape``), and its
function is rank 0's program over them.  Under tensor parallelism every
family runs on its per-device layout (``models.tensor_parallel`` and
its family modules ``tp_mamba2``, ``tp_whisper``): weights read as their
``model`` blocks (``train.loop.local_view``), rows kept on their
``data`` shard, cache leaves on the blocks ``cache_specs`` gives them,
activations moved instead; a prefill keeps the rank's part of the cache
(the kv heads it read, its conv channels and SSM heads, its head or
head_dim block of Whisper's K/V), a decode step samples from the rank's
vocab block.  The ``fsdp`` layout (``par.tp`` False) reads every leaf
through the gathered view (``train.loop.gathered_view``), and its decode
steps take the rows and every cache leaf outside the sequence-parallel
ones whole.  So a cell's argument bytes are a JAX device's, and its temp
and collective bytes are the port's.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from repro_torch import tree as T
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.distributed.sharding import (ParallelContext, gather_leaf,
                                              local_shape, param_specs,
                                              shard_of, stack_layers)
from repro_torch.models import api
from repro_torch.serving.sampler import SamplerConfig, distributed_sample
from repro_torch.train.optimizer import AdamWConfig, init_opt_state


def _maybe_axis(par: ParallelContext, axis, dim: int):
    """Shard ``dim`` over ``axis`` only when it divides (GSPMD would pad;
    shard_map would reject)."""
    if par.mesh is None or axis is None:
        return None
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    axes = tuple(a for a in axes if a in par.axes)
    if not axes:
        return None
    size = math.prod(par.shape[a] for a in axes)
    return (axes if len(axes) > 1 else axes[0]) if dim % size == 0 else None


# Per-arch gradient-accumulation factors for the train_4k dry-run: cells
# whose single-shot activation working set exceeds v5e HBM split the
# global batch into sequential microbatches (the standard memory/compute
# trade; semantics tested in test_microbatch_close_to_full_batch).
TRAIN_MICROBATCHES = {
    "command-r-35b": 8,
    "internvl2-1b": 1,  # microbatch scan regressed temp — see §Dry-run fit note
    "mamba2-130m": 1,   # microbatch scan regressed temp — see §Dry-run fit note
    "mixtral-8x7b": 4,
    "olmoe-1b-7b": 4,
    "qwen2.5-14b": 2,
    "whisper-base": 1,  # microbatch scan regressed temp — see §Dry-run fit note
}


@dataclasses.dataclass(frozen=True)
class Arg:
    """One input: its global shape, dtype and spec."""
    shape: tuple
    dtype: torch.dtype
    spec: tuple


def _spec(par: ParallelContext, *parts) -> tuple:
    return tuple(parts) if par.mesh is not None else (None,) * len(parts)


# ---------------------------------------------------------------------------
# Input specs (the model-input stand-ins)
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: InputShape, par: ParallelContext,
                *, n_patches: int = 256) -> dict:
    B, S = shape.global_batch, shape.seq_len
    baxes = ("pod", "data") if par.tp else ("pod", "data", "model")
    batch_ax = _maybe_axis(par, baxes, B)
    tok = _spec(par, batch_ax, None)
    vec = _spec(par, batch_ax)
    emb = _spec(par, batch_ax, None, None)
    dtype = getattr(torch, cfg.dtype)

    def embeddings(specs):
        if cfg.frontend == "patch_stub":
            specs["embeddings"] = Arg((B, n_patches, cfg.d_model), dtype, emb)
        if cfg.family == "encdec":
            specs["embeddings"] = Arg((B, cfg.encoder_seq_len, cfg.d_model),
                                      dtype, emb)
        return specs

    if shape.kind == "train":
        return embeddings({"tokens": Arg((B, S), torch.int32, tok),
                           "targets": Arg((B, S), torch.int32, tok),
                           "mask": Arg((B, S), torch.float32, tok)})
    if shape.kind == "prefill":
        return embeddings({"tokens": Arg((B, S), torch.int32, tok),
                           "lengths": Arg((B,), torch.int32, vec)})
    # decode: one new token against a cache of S
    return {"tokens": Arg((B, 1), torch.int32, tok),
            "cache_len": Arg((B,), torch.int32, vec)}


# ---------------------------------------------------------------------------
# Cache sharding specs
# ---------------------------------------------------------------------------


def cache_specs(cfg: ModelConfig, par: ParallelContext, abstract_cache: dict,
                batch: int) -> dict:
    """Spec per leaf of a dense decode cache ({name: tensor})."""
    seq_ax_name = par.kv_seq_axis
    batch_ax = _maybe_axis(par, ("pod", "data"), batch)
    if seq_ax_name is not None and batch_ax is not None:
        bt = (batch_ax,) if isinstance(batch_ax, str) else tuple(batch_ax)
        bt = tuple(a for a in bt if a != seq_ax_name)
        batch_ax = bt if len(bt) > 1 else (bt[0] if bt else None)

    def one(key, leaf):
        if key in ("k", "v", "attn_k", "attn_v", "cross_k", "cross_v"):
            # (L, B, S, Hkv, D) — flash-decoding shards seq over kv_seq_axis
            if seq_ax_name is not None:
                seq_ax = _maybe_axis(par, seq_ax_name, leaf.shape[2])
                return _spec(par, None, batch_ax, seq_ax, None, None)
            heads_ax = _maybe_axis(par, "model", leaf.shape[3])
            # GQA head counts (8, 1) rarely divide the 16-way model axis:
            # fall back to sharding head_dim
            hd_ax = (None if heads_ax is not None
                     else _maybe_axis(par, "model", leaf.shape[4]))
            return _spec(par, None, batch_ax, None, heads_ax, hd_ax)
        if key == "conv":      # (L, B, W-1, conv_dim)
            return _spec(par, None, batch_ax, None,
                         _maybe_axis(par, "model", leaf.shape[3]))
        if key == "ssm":       # (L, B, H, P, N)
            return _spec(par, None, batch_ax,
                         _maybe_axis(par, "model", leaf.shape[2]), None,
                         None)
        return (None,) * leaf.dim()

    return {k: one(k, v) for k, v in abstract_cache.items()}


# ---------------------------------------------------------------------------
# Cell builders
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cell:
    """``fn(*args)`` is rank 0's step (``kind``: train, prefill or
    decode); ``args`` are ``meta`` tensor trees of rank 0's blocks,
    ``specs`` their specs (congruent trees; None for a plain Python
    argument), ``global_args`` the global tensors on ``meta``.  The step
    updates its cache, params and moments in place (the JAX package
    donates them)."""
    name: str
    kind: str
    fn: object
    args: tuple
    specs: tuple
    global_args: tuple


def block_of(x: torch.Tensor, spec, par: ParallelContext) -> torch.Tensor:
    """An empty ``meta`` tensor of rank 0's block of ``x`` under
    ``spec``."""
    return torch.empty(local_shape(x.shape, spec, par), dtype=x.dtype,
                       device="meta")


def serve_params(cfg: ModelConfig, *, quantized: bool) -> dict:
    """The serve weights on ``meta``: every f32 leaf in bf16 (the f32
    master copies exist only in training), then tile-Q4 / Q8 leaves under
    the deployment policy when ``quantized``."""
    aparams = T.map_with_path(
        lambda _, a: a.to(torch.bfloat16) if a.dtype == torch.float32
        else a, api.abstract_params(cfg))
    if quantized:
        from repro_torch.quant.qlinear import quantize_model_params

        aparams = quantize_model_params(aparams)
    return aparams


def abstract_tree(cfg: ModelConfig, *, serve: bool, quantized: bool) -> dict:
    """The cell's global parameter tree on ``meta`` in the JAX layout: the
    f32 masters for training, :func:`serve_params` for serving.  Built
    once per architecture (meta tensors hold no values, so cells share
    them; the decode-only cache fields do not change the tree)."""
    return _abstract_tree(cfg.with_(kv_partition="batch", ring_cache=False),
                          serve, quantized)


@functools.lru_cache(maxsize=None)
def _abstract_tree(cfg, serve, quantized):
    return stack_layers(serve_params(cfg, quantized=quantized) if serve
                        else api.abstract_params(cfg))


def build_cell(arch: str, shape: InputShape, par: ParallelContext,
               *, smoke: bool = False, quantized: bool = False,
               microbatches: int = 0) -> Cell:
    """``quantized``: serve cells run with tile-Q4_0 weight leaves (Q8_0
    down-proj), the paper's §5.1 deployment, so the dry-run counts the
    kernels' int4/int8 byte traffic."""
    from repro_torch.models import tensor_parallel as TP
    from repro_torch.train.loop import gathered_view, local_view

    cfg = get_config(arch, smoke=smoke)
    cache_len_cap = shape.seq_len
    if shape.kind == "decode" and cfg.family != "encdec":
        # flash-decoding: KV seq over "model" for batched decode (batch
        # occupies the data axis); over "data" for batch-1 long context.
        # (whisper's decoder computes on its cache's head or head_dim
        # blocks instead: models.tp_whisper)
        axis = "data" if shape.name == "long_500k" else "model"
        cfg = cfg.with_(kv_partition="sequence")
        par = dataclasses.replace(par, kv_seq_axis=axis)
        # uniformly-windowed archs (mixtral SWA) use a ring cache of
        # window_size slots — 128x less KV memory at 500k context.
        if (cfg.window_size and not cfg.attn_pattern.startswith("local_global")
                and cfg.window_size < shape.seq_len):
            cfg = cfg.with_(ring_cache=True)
            cache_len_cap = cfg.window_size
    if shape.kind != "train":
        # serving: weights replicated over data; TP over model only.
        par = dataclasses.replace(par, fsdp=False)
    else:
        # training: sequence-shard the remat-saved residual stream over the
        # model axis (Megatron SP; the transformer family's layout)
        par = dataclasses.replace(par, shard_activations_seq=True)
    model = api.get_model(cfg)
    aparams = abstract_tree(cfg, serve=shape.kind != "train",
                            quantized=quantized and shape.kind != "train")
    pspecs = param_specs(aparams, par,
                         stacked_prefixes=("layers", "enc_layers",
                                           "dec_layers"))
    params = T.map_with_path(lambda _, a, s: block_of(a, s, par), aparams,
                             pspecs)
    specs = input_specs(cfg, shape, par)
    globals_ = {k: torch.empty(a.shape, dtype=a.dtype, device="meta")
                for k, a in specs.items()}
    blocks = {k: block_of(globals_[k], a.spec, par)
              for k, a in specs.items()}
    S = shape.seq_len
    name = f"{arch}:{shape.name}"

    if shape.kind == "train":
        from repro_torch.train.loop import make_train_step

        oc = AdamWConfig()
        mb = microbatches or TRAIN_MICROBATCHES.get(arch, 1)
        step = make_train_step(cfg, oc, par, microbatches=mb, specs=pspecs)
        opt = init_opt_state(params)
        aopt = init_opt_state(aparams)
        keys = ["tokens", "targets", "mask"]
        if "embeddings" in specs:
            keys.append("embeddings")
        bspecs = tuple(specs[k].spec for k in keys)

        def train_fn(params, opt_state, *batch):
            # the port's step takes the global batch and cuts each rank's
            # rows itself: the rows come whole first
            batch = tuple(gather_leaf(b, s, par)
                          for b, s in zip(batch, bspecs))
            return step(params, opt_state, batch)

        ospecs = {"m": pspecs, "v": pspecs, "step": ()}
        return Cell(name, "train", train_fn,
                    (params, opt, *(blocks[k] for k in keys)),
                    (pspecs, ospecs, *bspecs),
                    (aparams, aopt, *(globals_[k] for k in keys)))

    row_axes = specs["tokens"].spec[0]
    tp = TP.TPLayout(par, rows=row_axes) if TP.applies(cfg, par) else None

    fam = TP.family(cfg)
    t_enc = {"t_enc": cfg.encoder_seq_len} if cfg.family == "encdec" else {}

    if shape.kind == "prefill" and tp is not None:
        def tp_prefill_fn(params, tokens, lengths, embeddings=None):
            cache = fam.init_cache(cfg, tp, tokens.shape[0], S,
                                   device=tokens.device, **t_enc)
            logits = fam.prefill(local_view(params, pspecs, par), tokens, cfg,
                                 tp, lengths=lengths, cache=cache,
                                 embeddings=embeddings)
            return logits, cache

        keys = ["tokens", "lengths"] + (["embeddings"] if "embeddings" in
                                        specs else [])
        return Cell(name, "prefill", tp_prefill_fn,
                    (params, *(blocks[k] for k in keys)),
                    (pspecs, *(specs[k].spec for k in keys)),
                    (aparams, *(globals_[k] for k in keys)))

    if shape.kind == "prefill":
        def prefill_fn(params, tokens, lengths, embeddings=None):
            kw = {"embeddings": embeddings} if embeddings is not None else {}
            if cfg.family == "transformer":
                kw.update(par=par, row_axes=row_axes)
            cache = model.init_cache(cfg, tokens.shape[0], S,
                                     device=tokens.device, **t_enc)
            logits = model.prefill(gathered_view(params, pspecs, par),
                                   tokens, cfg, lengths=lengths,
                                   cache=cache, **kw)
            return logits, cache

        keys = ["tokens", "lengths"] + (["embeddings"] if "embeddings" in
                                        specs else [])
        return Cell(name, "prefill", prefill_fn,
                    (params, *(blocks[k] for k in keys)),
                    (pspecs, *(specs[k].spec for k in keys)),
                    (aparams, *(globals_[k] for k in keys)))

    # decode / long-context decode: serve_step = decode + sample
    t_enc = cfg.encoder_seq_len if cfg.family == "encdec" else 0
    B = shape.global_batch
    acache = api.abstract_cache(cfg, B, S if cfg.family == "encdec"
                                else cache_len_cap, t_enc=t_enc)
    cspecs = cache_specs(cfg, par, acache, B)
    cache = {k: block_of(v, cspecs[k], par) for k, v in acache.items()}
    seq_par = par.mesh is not None and par.kv_seq_axis is not None
    # the sequence-parallel layer takes this rank's block of the KV leaves;
    # every other leaf the model takes whole
    blockwise = ("k", "v", "attn_k", "attn_v") if seq_par else ()
    tok_spec, vec_spec = specs["tokens"].spec, specs["cache_len"].spec
    sc = SamplerConfig(temperature=0.8)

    if tp is not None:
        def tp_serve_fn(params, cache, tokens, cache_len, seed):
            view = local_view(params, pspecs, par)
            logits = fam.decode_step(view, tokens, cache, cache_len, cfg, tp)
            return TP.sample(logits.float(), seed, sc, cfg, tp), cache

        return Cell(name, "decode", tp_serve_fn,
                    (params, cache, blocks["tokens"], blocks["cache_len"], 0),
                    (pspecs, cspecs, tok_spec, vec_spec, None),
                    (aparams, acache, globals_["tokens"],
                     globals_["cache_len"], 0))

    def serve_fn(params, cache, tokens, cache_len, seed):
        tokens = gather_leaf(tokens, tok_spec, par)
        cache_len = gather_leaf(cache_len, vec_spec, par)
        whole = {k: v if k in blockwise else gather_leaf(v, cspecs[k], par)
                 for k, v in cache.items()}
        view = gathered_view(params, pspecs, par)
        if cfg.family == "encdec":
            logits = model.decode_step(view, tokens, whole, cache_len, cfg)
        else:
            logits = model.decode_step(view, tokens, whole, cache_len, cfg,
                                       par)
        for k, v in cache.items():
            if whole[k] is not v:
                v.copy_(shard_of(whole[k], cspecs[k], par))
        tok = distributed_sample(logits.float(), seed, sc, par)
        return tok, cache

    return Cell(name, "decode", serve_fn,
                (params, cache, blocks["tokens"], blocks["cache_len"], 0),
                (pspecs, cspecs, tok_spec, vec_spec, None),
                (aparams, acache, globals_["tokens"], globals_["cache_len"],
                 0))
