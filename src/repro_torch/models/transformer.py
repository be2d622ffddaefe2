"""Decoder-only transformer covering the dense / GQA / bias / sliding
window / local:global / MoE members of the JAX package's architecture
pool, with a paged or a dense KV cache.

Parameters are a dict {"embedding": {"table"}, "layers": [per-layer
dict, ...], "final_norm": {"scale"}[, "lm_head"][, "patch_proj"]}; a
layer holds a SwiGLU "ffn" or an MoE "moe" (``models/moe.py``).  The
layers run as a Python loop (the JAX package scans stacked layer leaves
instead; ``bridge`` splits them).  Both KV layouts are updated **in
place**.  The paged layout is a block pool: ``prefill`` scatters the
prompt's KV into the rows' blocks and ``decode_step`` writes one token
per row, both through per-row block tables.  The dense layout
(``init_cache``) gives every row its own (max_len, Hkv, D) slots per
layer.  A ``patch_stub`` frontend (internvl2) takes precomputed
modality embeddings through ``patch_proj`` in place of the first P
positions' token embeddings.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import param_generator, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.moe import init_moe, moe_ffn


def layer_windows(cfg: ModelConfig) -> list[int]:
    """Per-layer sliding window sizes (0 = unbounded full attention)."""
    if cfg.attn_pattern.startswith("local_global"):
        ratio = int(cfg.attn_pattern.split(":")[1])
        return [cfg.window_size if (i % (ratio + 1)) != ratio else 0
                for i in range(cfg.n_layers)]
    return [cfg.window_size] * cfg.n_layers


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None) -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (CUDA unless asked otherwise), in ``cfg.param_dtype``.  Same
    distributions as the JAX package's init; not the same numbers."""
    if cfg.family != "transformer":
        raise ValueError(f"the port's transformer module serves the "
                         f"transformer family, got {cfg.family!r}")
    dev = resolve_device(device)
    gen = param_generator(dev, seed)
    dtype = getattr(torch, cfg.param_dtype)

    def dense(i: int, o: int, bias: bool = False) -> dict:
        w = torch.randn((i, o), generator=gen, device=dev) / math.sqrt(i)
        p = {"w": w.to(dtype)}
        if bias:
            p["b"] = torch.zeros((o,), dtype=dtype, device=dev)
        return p

    def norm() -> dict:
        return {"scale": torch.ones((cfg.d_model,), device=dev)}

    d, hd = cfg.d_model, cfg.resolved_head_dim()
    layers = []
    for _ in range(cfg.n_layers):
        layer = {
            "attn_norm": norm(),
            "attn": {
                "wq": dense(d, cfg.n_heads * hd, cfg.qkv_bias),
                "wk": dense(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
                "wv": dense(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
                "wo": dense(cfg.n_heads * hd, d),
            },
            "ffn_norm": norm(),
        }
        if cfg.moe:
            layer["moe"] = init_moe(cfg, gen, dtype, dev)
        else:
            layer["ffn"] = {"gate": dense(d, cfg.d_ff),
                            "up": dense(d, cfg.d_ff),
                            "down": dense(cfg.d_ff, d)}
        layers.append(layer)
    table = torch.randn((cfg.vocab_size, d), generator=gen, device=dev) * 0.02
    params = {"embedding": {"table": table.to(dtype)}, "layers": layers,
              "final_norm": norm()}
    if not cfg.tie_embeddings:
        head = torch.randn((cfg.vocab_size, d), generator=gen,
                           device=dev) * 0.02
        params["lm_head"] = {"table": head.to(dtype)}
    if cfg.frontend == "patch_stub":
        params["patch_proj"] = dense(d, d)
    return params


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               device) -> dict:
    """Dense KV rows: (L, batch, max_len, Hkv, D) per leaf, zeroed."""
    dtype = dtype or getattr(torch, cfg.dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim())
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_paged_cache(cfg: ModelConfig, n_blocks: int, block_size: int,
                     dtype=None, *, device) -> dict:
    """Block-pool KV storage: (L, n_blocks, block_size, Hkv, D) per leaf."""
    dtype = dtype or getattr(torch, cfg.dtype)
    shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads,
             cfg.resolved_head_dim())
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def pool_layer(pool, layer: int):
    """Layer ``layer``'s view (n_blocks, bs, ...) of a stacked pool leaf
    (tensor or quantized dict); writes to it land in the pool."""
    if isinstance(pool, dict):
        return {k: v[layer] for k, v in pool.items()}
    return pool[layer]


# ---------------------------------------------------------------------------
# Layer body and forward passes
# ---------------------------------------------------------------------------


def _layer(p, x, cfg, *, positions, window, cache=None, cache_len=None,
           prefix_kv=None, prefix_positions=None, par=None, row_axes=None):
    """One layer.  Returns (x, kv, aux): aux is the MoE layer's
    load-balancing loss, None for a dense layer (serving launches no
    kernel for it).  ``par`` / ``row_axes``: the MoE's mesh and the axes
    x's rows are split over (``moe_ffn``)."""
    h, kv = L.attention_block(
        p["attn"], L.rmsnorm(p["attn_norm"], x, cfg.norm_eps), cfg,
        positions=positions, window=window, cache=cache, cache_len=cache_len,
        prefix_kv=prefix_kv, prefix_positions=prefix_positions,
        aligned=cache is None and prefix_kv is None)
    x = x + h
    hn = L.rmsnorm(p["ffn_norm"], x, cfg.norm_eps)
    if "moe" in p:
        h, aux = moe_ffn(p["moe"], hn, cfg, par, row_axes=row_axes)
    else:
        h, aux = L.swiglu(p["ffn"], hn), None
    return x + h, kv, aux


def _train_layer(p, x, cfg, positions, window, par=None, row_axes=None):
    x, _, aux = _layer(p, x, cfg, positions=positions, window=window,
                       par=par, row_axes=row_axes)
    return x, aux


def _head(params, cfg):
    return params["embedding"] if cfg.tie_embeddings else params["lm_head"]


def forward(params, tokens, cfg: ModelConfig, *,
            logit_positions: Optional[torch.Tensor] = None,
            return_kv: bool = False, prefix: Optional[dict] = None,
            embeddings: Optional[torch.Tensor] = None,
            return_aux: bool = False, par=None, row_axes="batch"):
    """Full-sequence forward.  tokens: (B, S).  Returns (logits, kvs):
    logits (B, S, V) f32, or (B, V) at ``logit_positions`` (B,); kvs as
    :func:`trunk` returns them.  ``return_aux`` appends the summed MoE
    load-balancing loss of the layers (zero without MoE), which the JAX
    package's ``forward`` returns and training adds.  ``par``,
    ``row_axes``: see :func:`trunk`."""
    x, kvs, aux = trunk(params, tokens, cfg, return_kv=return_kv,
                        prefix=prefix, embeddings=embeddings,
                        return_aux=True, par=par, row_axes=row_axes)
    if logit_positions is not None:
        B = tokens.shape[0]
        x = x[torch.arange(B, device=x.device), logit_positions.long()]
    logits = L.lm_logits(_head(params, cfg), x, cfg.logit_softcap)
    return (logits, kvs, aux) if return_aux else (logits, kvs)


def trunk(params, tokens, cfg: ModelConfig, *, return_kv: bool = False,
          prefix: Optional[dict] = None,
          embeddings: Optional[torch.Tensor] = None,
          return_aux: bool = False, par=None, row_axes="batch"):
    """The layers and final norm, without the LM head (the reward model
    puts its own head on them).  tokens: (B, S).  Returns (x, kvs): x
    (B, S, d_model) in ``cfg.dtype``; kvs the per-layer rope'd (k, v) of
    shape (B, S, Hkv, D) when ``return_kv``.

    ``prefix``: a cached-prefix handle for partial prefill, {"k", "v":
    (L, B, P, Hkv, D) already-rope'd per-layer prefix KV, "len": (B,)
    int32 cached lengths}.  ``tokens`` then holds only the uncached
    suffix: token j of row b sits at position ``len[b] + j``, queries
    attend over prefix + suffix, and the returned KV covers the suffix
    alone.  Prefix slots at or past a row's cached length get position
    ``P + S``, past every query, so the causal mask hides them.

    ``embeddings``: optional (B, P, d) modality-stub prefix (VLM patches)
    which, through ``patch_proj``, replaces the embedding of the first P
    positions; it cannot be combined with a cached ``prefix``.

    ``return_aux`` appends the layers' summed MoE loss.  With
    ``cfg.remat == "full"`` and activations that carry gradients
    (training), each layer runs under ``torch.utils.checkpoint`` (the JAX
    package's ``jax.checkpoint``).

    ``par``: a mesh, under which ``tokens`` are this rank's rows of a
    batch split over ``par.spec("batch")`` (the sharded train step's
    layout; ``row_axes`` names other axes, None the whole batch).  Only an
    MoE layer's math depends on it (``moe_ffn``: its token shards and its
    experts' ff split); the rest is per row."""
    dtype = getattr(torch, cfg.dtype)
    if par is None or par.mesh is None:
        row_axes = None
    elif row_axes == "batch":
        row_axes = par.spec("batch")[0]
    x = L.embed(params["embedding"], tokens, dtype)
    if embeddings is not None:
        if prefix is not None:
            raise NotImplementedError(
                "modality-stub embeddings cannot be combined with a cached "
                "prefix (the patch positions would be ambiguous)")
        pre = L.linear(params["patch_proj"], embeddings.to(dtype))
        x = torch.cat([pre, x[:, embeddings.shape[1]:]], dim=1)
    B, S = tokens.shape
    arange = torch.arange(S, dtype=torch.int32, device=tokens.device)[None]
    prefix_positions = None
    if prefix is None:
        positions = arange.expand(B, S)
    else:
        offset = prefix["len"].to(torch.int32)
        positions = offset[:, None] + arange
        P = prefix["k"].shape[2]
        parr = torch.arange(P, dtype=torch.int32, device=tokens.device)[None]
        prefix_positions = torch.where(parr < offset[:, None], parr,
                                       torch.full_like(parr, P + S))
    kvs = []
    aux = None
    remat = cfg.remat == "full" and x.requires_grad and prefix is None \
        and not return_kv
    for i, (lp, w) in enumerate(zip(params["layers"], layer_windows(cfg))):
        if remat:
            x, a = checkpoint(_train_layer, lp, x, cfg, positions, w, par,
                              row_axes, use_reentrant=False)
        else:
            pkv = None if prefix is None else (prefix["k"][i],
                                               prefix["v"][i])
            x, kv, a = _layer(lp, x, cfg, positions=positions, window=w,
                              prefix_kv=pkv,
                              prefix_positions=prefix_positions, par=par,
                              row_axes=row_axes)
            if return_kv:
                kvs.append(kv)
        if a is not None:
            aux = a if aux is None else aux + a
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if not return_aux:
        return x, kvs
    return x, kvs, (torch.zeros((), device=x.device) if aux is None
                    else aux)


def _scatter_prefill_blocks(pool, kv, table, block_size: int) -> None:
    """Write prefill KV (B, S, Hkv, D) into one layer's pool blocks, in
    place.  S is padded up to a block multiple; chunk j of row b goes to
    block ``table[b, j]``.  Chunks past a row's true block count carry
    padding and target the scratch block (table padding = 0), which is
    never attended.  Quantized pools are written as code and scale leaves
    through the same index math."""
    from repro_torch.serving.kv_quant import quantize_for_pool

    B, S = kv.shape[:2]
    nS = -(-S // block_size)
    pad = nS * block_size - S
    if pad:
        kv = torch.nn.functional.pad(kv, (0, 0, 0, 0, 0, pad))
    chunks = kv.reshape(B * nS, block_size, *kv.shape[2:])
    blocks = table[:, :nS].reshape(-1).long()
    payload = quantize_for_pool(chunks, pool)
    if isinstance(pool, dict):
        for name in ("codes", "scales"):
            pool[name][blocks] = payload[name].to(pool[name].dtype)
    else:
        pool[blocks] = payload.to(pool.dtype)


def _scatter_suffix_blocks(pool, kv, table, block_size: int, start) -> None:
    """Write suffix KV (B, S, Hkv, D) into one layer's pool blocks at a
    per-row offset, in place: row b's token j lands at position
    ``start[b] + j``, i.e. pool[table[b, pos // bs], pos % bs].

    Position by position, not whole blocks, because a mid-block cached
    prefix leaves the first suffix tokens inside a partly filled tail
    block whose earlier offsets must survive.  Positions past the table
    (padding) are clamped to its last slot: an unattended offset or the
    scratch block.  Quantized groups never span tokens, so per-position
    writes of codes and scales are exact."""
    from repro_torch.serving.kv_quant import quantize_for_pool

    S = kv.shape[1]
    W = table.shape[1]
    pos = start.to(torch.int64)[:, None] + torch.arange(S, device=kv.device)
    pos = torch.clamp_max(pos, W * block_size - 1)           # (B, S)
    blk = torch.gather(table.long(), 1, pos // block_size)
    off = pos % block_size
    payload = quantize_for_pool(kv, pool)
    if isinstance(pool, dict):
        for name in ("codes", "scales"):
            pool[name][blk, off] = payload[name].to(pool[name].dtype)
    else:
        pool[blk, off] = payload.to(pool.dtype)


def prefill(params, tokens, cfg: ModelConfig, *, lengths,
            paged: Optional[dict] = None, cache: Optional[dict] = None,
            prefix: Optional[dict] = None,
            embeddings: Optional[torch.Tensor] = None, par=None,
            row_axes="batch"):
    """Run right-padded prompts and write their KV into a cache, in place.
    Exactly one of ``paged`` and ``cache`` is given.

    tokens: (B, S); lengths: (B,) true prompt lengths; ``paged``:
    {"k", "v", "table"} — stacked pool leaves (L, n_blocks, bs, Hkv, D)
    (or quantized dicts) and a (B, W) int32 table whose first
    ceil(S / bs) columns hold each row's prompt blocks.  ``cache``: dense
    rows {"k", "v"} of (L, B, max_len, Hkv, D) from :func:`init_cache`,
    whose first S slots take the prompt's KV (padding included, masked
    later by the rows' lengths).  Returns the (B, V) f32 logits at each
    row's last prompt position.

    ``prefix``: a cached-prefix handle (see :func:`forward`) for partial
    prefill, paged only; ``tokens``/``lengths`` then describe only the
    uncached suffix, whose KV is written into the table at offset
    ``prefix["len"]`` while the cached positions stay untouched.
    ``embeddings``: the modality-stub prefix of :func:`trunk`.  ``par``,
    ``row_axes``: the rows are this rank's of a batch split over
    ``row_axes`` (:func:`trunk`; the dry-run's prefill under a mesh)."""
    from repro_torch.serving.kv_quant import pool_block_size

    if (paged is None) == (cache is None):
        raise ValueError("prefill takes exactly one of paged= and cache=")
    if prefix is not None and paged is None:
        raise ValueError("partial prefill over a cached prefix requires the "
                         "paged cache layout")
    logits, kvs = forward(params, tokens, cfg, logit_positions=lengths - 1,
                          return_kv=True, prefix=prefix,
                          embeddings=embeddings, par=par, row_axes=row_axes)
    if cache is not None:
        S = tokens.shape[1]
        for layer, (k, v) in enumerate(kvs):
            cache["k"][layer, :, :S] = k.to(cache["k"].dtype)
            cache["v"][layer, :, :S] = v.to(cache["v"].dtype)
        return logits
    if prefix is not None:
        scatter_suffix(paged, kvs, prefix["len"])
        return logits
    bs = pool_block_size(paged["k"], axis=2)
    for layer, (k, v) in enumerate(kvs):
        for pool, new in ((paged["k"], k), (paged["v"], v)):
            _scatter_prefill_blocks(pool_layer(pool, layer), new,
                                    paged["table"], bs)
    return logits


def scatter_suffix(paged: dict, kvs, start) -> None:
    """Write per-layer suffix KV (B, S, Hkv, D), as :func:`forward`
    returns it, into a paged cache in place: row b's token j lands at
    position ``start[b] + j`` (clamped to the table's last slot)."""
    from repro_torch.serving.kv_quant import pool_block_size

    bs = pool_block_size(paged["k"], axis=2)
    for layer, (k, v) in enumerate(kvs):
        for pool, new in ((paged["k"], k), (paged["v"], v)):
            _scatter_suffix_blocks(pool_layer(pool, layer), new,
                                   paged["table"], bs, start)


def decode_step(params, tokens, cache: dict, cache_len, cfg: ModelConfig,
                par=None):
    """One decode step over a paged or a dense cache.

    tokens: (B, 1) current tokens; cache: the paged {"k", "v", "table"}
    or the dense {"k", "v"} of :func:`prefill`; cache_len: (B,) int32
    sequence length *after* this token is appended.  Writes each row's
    K/V into the cache in place and returns the (B, V) f32 next-token
    logits.

    ``par`` with a ``kv_seq_axis``: sequence-parallel decode.  tokens,
    cache_len and the logits are the global rows (the same on every
    rank); the dense cache is this rank's block of it
    (``serving.seq_parallel.shard_cache``).  A paged cache refuses it,
    as in the JAX package."""
    dtype = getattr(torch, cfg.dtype)
    x = L.embed(params["embedding"], tokens, dtype)
    positions = (cache_len - 1)[:, None]
    seq_par = par is not None and par.kv_seq_axis is not None
    if "table" in cache and seq_par:
        raise NotImplementedError(
            "paged KV cache is not supported with sequence-parallel decode")
    for layer, (lp, w) in enumerate(zip(params["layers"],
                                        layer_windows(cfg))):
        layer_cache = {"k": pool_layer(cache["k"], layer),
                       "v": pool_layer(cache["v"], layer)}
        if seq_par:
            from repro_torch.serving.seq_parallel import \
                seq_parallel_decode_layer
            x, _, _ = seq_parallel_decode_layer(
                lp, x, cfg, par, cache_k=layer_cache["k"],
                cache_v=layer_cache["v"], cache_len=cache_len, window=w)
            continue
        if "table" in cache:
            layer_cache["table"] = cache["table"]
        x, _, _ = _layer(lp, x, cfg, positions=positions, window=w,
                         cache=layer_cache, cache_len=cache_len, par=par)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.lm_logits(_head(params, cfg), x[:, 0], cfg.logit_softcap)
