"""Dense GQA decoder-only transformer (the qwen2.5 family) with a paged
KV cache.

Parameters are a dict {"embedding": {"table"}, "layers": [per-layer
dict, ...], "final_norm": {"scale"}}; the layers run as a Python loop
(the JAX package scans stacked layer leaves instead; ``bridge`` splits
them).  The KV cache is a block pool updated **in place**: ``prefill``
scatters the prompt's KV into the rows' blocks and ``decode_step`` writes
one token per row, both through per-row block tables.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L


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
    if cfg.family != "transformer" or cfg.moe is not None:
        raise ValueError(f"the port supports dense transformers only, got "
                         f"{cfg.family!r}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
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
        layers.append({
            "attn_norm": norm(),
            "attn": {
                "wq": dense(d, cfg.n_heads * hd, cfg.qkv_bias),
                "wk": dense(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
                "wv": dense(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
                "wo": dense(cfg.n_heads * hd, d),
            },
            "ffn_norm": norm(),
            "ffn": {"gate": dense(d, cfg.d_ff), "up": dense(d, cfg.d_ff),
                    "down": dense(cfg.d_ff, d)},
        })
    table = torch.randn((cfg.vocab_size, d), generator=gen, device=dev) * 0.02
    params = {"embedding": {"table": table.to(dtype)}, "layers": layers,
              "final_norm": norm()}
    if not cfg.tie_embeddings:
        head = torch.randn((cfg.vocab_size, d), generator=gen,
                           device=dev) * 0.02
        params["lm_head"] = {"table": head.to(dtype)}
    return params


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


def _layer(p, x, cfg, *, positions, window, cache=None, cache_len=None):
    h, kv = L.attention_block(
        p["attn"], L.rmsnorm(p["attn_norm"], x, cfg.norm_eps), cfg,
        positions=positions, window=window, cache=cache, cache_len=cache_len)
    x = x + h
    x = x + L.swiglu(p["ffn"], L.rmsnorm(p["ffn_norm"], x, cfg.norm_eps))
    return x, kv


def _head(params, cfg):
    return params["embedding"] if cfg.tie_embeddings else params["lm_head"]


def forward(params, tokens, cfg: ModelConfig, *,
            logit_positions: Optional[torch.Tensor] = None,
            return_kv: bool = False):
    """Full-sequence forward.  tokens: (B, S).  Returns (logits, kvs):
    logits (B, S, V) f32, or (B, V) at ``logit_positions`` (B,); kvs the
    per-layer rope'd (k, v) of shape (B, S, Hkv, D) when ``return_kv``."""
    dtype = getattr(torch, cfg.dtype)
    x = L.embed(params["embedding"], tokens, dtype)
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S)
    kvs = []
    for lp, w in zip(params["layers"], layer_windows(cfg)):
        x, kv = _layer(lp, x, cfg, positions=positions, window=w)
        if return_kv:
            kvs.append(kv)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if logit_positions is not None:
        x = x[torch.arange(B, device=x.device), logit_positions.long()]
    return L.lm_logits(_head(params, cfg), x, cfg.logit_softcap), kvs


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


def prefill(params, tokens, cfg: ModelConfig, *, lengths, paged: dict):
    """Run right-padded prompts and scatter their KV into a paged cache.

    tokens: (B, S); lengths: (B,) true prompt lengths; ``paged``:
    {"k", "v", "table"} — stacked pool leaves (L, n_blocks, bs, Hkv, D)
    (or quantized dicts) and a (B, W) int32 table whose first
    ceil(S / bs) columns hold each row's prompt blocks.  The pools are
    written in place.  Returns the (B, V) f32 logits at each row's last
    prompt position."""
    from repro_torch.serving.kv_quant import pool_block_size

    logits, kvs = forward(params, tokens, cfg,
                          logit_positions=lengths - 1, return_kv=True)
    bs = pool_block_size(paged["k"], axis=2)
    for layer, (k, v) in enumerate(kvs):
        _scatter_prefill_blocks(pool_layer(paged["k"], layer), k,
                                paged["table"], bs)
        _scatter_prefill_blocks(pool_layer(paged["v"], layer), v,
                                paged["table"], bs)
    return logits


def decode_step(params, tokens, cache: dict, cache_len, cfg: ModelConfig):
    """One decode step over a paged cache.

    tokens: (B, 1) current tokens; cache: {"k", "v", "table"} as in
    :func:`prefill`; cache_len: (B,) int32 sequence length *after* this
    token is appended.  Writes each row's K/V into the pools in place and
    returns the (B, V) f32 next-token logits."""
    dtype = getattr(torch, cfg.dtype)
    x = L.embed(params["embedding"], tokens, dtype)
    positions = (cache_len - 1)[:, None]
    for layer, (lp, w) in enumerate(zip(params["layers"],
                                        layer_windows(cfg))):
        layer_cache = {"k": pool_layer(cache["k"], layer),
                       "v": pool_layer(cache["v"], layer),
                       "table": cache["table"]}
        x, _ = _layer(lp, x, cfg, positions=positions, window=w,
                      cache=layer_cache, cache_len=cache_len)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.lm_logits(_head(params, cfg), x[:, 0], cfg.logit_softcap)
