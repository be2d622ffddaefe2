"""Whisper-style encoder-decoder (arXiv:2212.04356), the transformer
backbone only, as plain functions over parameter dicts of tensors.  The
conv audio frontend is a stub: callers pass precomputed frame embeddings
(B, T_enc, d_model) as ``embeddings`` (or ``frames``), which go through
the ``frame_proj`` linear and a sinusoidal position table.

Parameters are {"frame_proj", "enc_layers": [per-layer dict, ...],
"enc_norm", "embedding", "pos_embedding" (max_seq_len, d), "dec_layers":
[...], "dec_norm"}; the layers run as Python loops (the JAX package scans
stacked leaves; ``bridge`` splits them).  The encoder is bidirectional;
each decoder layer has causal self-attention without rope (absolute
``pos_embedding``), cross-attention over its own K/V of the encoder
output, and a GELU MLP.  The cache is dense rows, updated **in place**:
{"k", "v" (L, B, max_len, Hkv, D), "cross_k", "cross_v" (L, B, T_enc,
Hkv, D)}, batch on axis 1 of every leaf.  ``cfg.remat == "full"`` runs
each encoder and decoder layer under ``torch.utils.checkpoint`` when
its activations carry gradients (training).

Under a mesh with a ``model`` axis the same layers run on each weight's
and cache leaf's ``model`` block: ``models.tp_whisper`` (``encode``,
``forward``, ``prefill``, ``decode_step``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import param_generator, resolve_device
from repro_torch.models import layers as L


def _sinusoids(length: int, d: int, device=None) -> torch.Tensor:
    half = d // 2
    t = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=device) / (half - 1))
    ang = t * freq[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None) -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (CUDA unless asked otherwise), in ``cfg.param_dtype``.  The JAX
    package's distributions (linear weights N(0, 1/in) with zero biases,
    layer norms at 1 and 0, the embedding table N(0, 0.02^2), the
    decoder's ``pos_embedding`` N(0, 0.01^2)); not the same numbers."""
    if cfg.family != "encdec":
        raise ValueError(f"the port's whisper module serves the encdec "
                         f"family, got {cfg.family!r}")
    dev = resolve_device(device)
    gen = param_generator(dev, seed)
    dtype = getattr(torch, cfg.param_dtype)
    d, hd = cfg.d_model, cfg.resolved_head_dim()

    def dense(i: int, o: int, bias: bool) -> dict:
        w = torch.randn((i, o), generator=gen, device=dev) / math.sqrt(i)
        p = {"w": w.to(dtype)}
        if bias:
            p["b"] = torch.zeros((o,), dtype=dtype, device=dev)
        return p

    def norm() -> dict:
        return {"scale": torch.ones((d,), device=dev),
                "bias": torch.zeros((d,), device=dev)}

    def attn() -> dict:
        return {"wq": dense(d, cfg.n_heads * hd, cfg.qkv_bias),
                "wk": dense(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
                "wv": dense(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
                "wo": dense(cfg.n_heads * hd, d, False)}

    def mlp() -> dict:
        return {"fc1": dense(d, cfg.d_ff, True),
                "fc2": dense(cfg.d_ff, d, True)}

    enc = [{"attn_norm": norm(), "attn": attn(), "mlp_norm": norm(),
            "mlp": mlp()} for _ in range(cfg.n_encoder_layers)]
    dec = [{"attn_norm": norm(), "attn": attn(), "cross_norm": norm(),
            "cross": attn(), "mlp_norm": norm(), "mlp": mlp()}
           for _ in range(cfg.n_layers)]
    table = torch.randn((cfg.vocab_size, d), generator=gen, device=dev)
    pos = torch.randn((cfg.max_seq_len, d), generator=gen, device=dev)
    return {"frame_proj": dense(d, d, True),  # conv-frontend stub
            "enc_layers": enc, "enc_norm": norm(),
            "embedding": {"table": (table * 0.02).to(dtype)},
            "pos_embedding": pos.to(dtype) * 0.01,
            "dec_layers": dec, "dec_norm": norm()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               t_enc: int = 0, device) -> dict:
    """Dense rows, zeroed: self K/V (L, batch, max_len, Hkv, D) and cross
    K/V (L, batch, t_enc, Hkv, D), t_enc defaulting to
    ``cfg.encoder_seq_len``."""
    dtype = dtype or getattr(torch, cfg.dtype)
    hd = cfg.resolved_head_dim()
    t_enc = t_enc or cfg.encoder_seq_len
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, hd)
    xshape = (cfg.n_layers, batch, t_enc, cfg.n_kv_heads, hd)
    return {name: torch.zeros(s, dtype=dtype, device=device)
            for name, s in (("k", shape), ("v", shape), ("cross_k", xshape),
                            ("cross_v", xshape))}


def _remat(cfg: ModelConfig, x: torch.Tensor) -> bool:
    return cfg.remat == "full" and x.requires_grad


def _enc_layer(lp, x, cfg, positions):
    h, _ = L.attention_block(lp["attn"], L.layernorm(lp["attn_norm"], x),
                             cfg, positions=positions, window=0,
                             causal=False)
    x = x + h
    return x + L.mlp(lp["mlp"], L.layernorm(lp["mlp_norm"], x))


def encode(params, frames, cfg: ModelConfig) -> torch.Tensor:
    """frames: (B, T_enc, d_model) stub embeddings -> (B, T_enc, d)."""
    dtype = getattr(torch, cfg.dtype)
    x = L.linear(params["frame_proj"], frames.to(dtype))
    x = x + _sinusoids(x.shape[1], cfg.d_model, x.device).to(dtype)[None]
    B, T = x.shape[:2]
    positions = torch.arange(T, dtype=torch.int32,
                             device=x.device)[None].expand(B, T)
    for lp in params["enc_layers"]:
        if _remat(cfg, x):
            x = checkpoint(_enc_layer, lp, x, cfg, positions,
                           use_reentrant=False)
        else:
            x = _enc_layer(lp, x, cfg, positions)
    return L.layernorm(params["enc_norm"], x)


def _cross_kv(params, enc_out, cfg) -> list:
    """Per decoder layer, the cross-attention (k, v), each (B, T_enc,
    Hkv, D)."""
    hd = cfg.resolved_head_dim()
    B, T = enc_out.shape[:2]
    return [(L.linear(lp["cross"]["wk"], enc_out).reshape(
                B, T, cfg.n_kv_heads, hd),
             L.linear(lp["cross"]["wv"], enc_out).reshape(
                B, T, cfg.n_kv_heads, hd))
            for lp in params["dec_layers"]]


def _dec_layer(lp, x, cfg, positions, cross_k, cross_v, cache=None,
               cache_len=None):
    h, kv = L.attention_block(lp["attn"], L.layernorm(lp["attn_norm"], x),
                              cfg, positions=positions, window=0,
                              cache=cache, cache_len=cache_len)
    x = x + h
    h, _ = L.attention_block(lp["cross"], L.layernorm(lp["cross_norm"], x),
                             cfg, positions=positions, window=0,
                             cross_kv=(cross_k, cross_v),
                             cache=None if cache is None else {})
    x = x + h
    return x + L.mlp(lp["mlp"], L.layernorm(lp["mlp_norm"], x)), kv


def forward(params, tokens, cfg: ModelConfig, *,
            embeddings: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None,
            logit_positions: Optional[torch.Tensor] = None,
            return_kv: bool = False, return_aux: bool = False):
    """Teacher-forced decoder over the encoded frames.  tokens: (B, S);
    ``frames`` (or ``embeddings``): (B, T_enc, d).  Returns (logits, (kvs,
    cross)): logits (B, S, V) f32, or (B, V) at ``logit_positions`` (B,);
    kvs the per-layer self (k, v) (B, S, Hkv, D) when ``return_kv`` (else
    empty), cross the per-layer cross (k, v).  ``return_aux`` appends the
    auxiliary loss, zero for this family, as the JAX package returns
    it."""
    if frames is None:
        frames = embeddings
    if frames is None:
        raise ValueError("the encdec family needs frame embeddings "
                         "(embeddings=, (B, T_enc, d_model))")
    enc_out = encode(params, frames, cfg)
    cross = _cross_kv(params, enc_out, cfg)
    dtype = getattr(torch, cfg.dtype)
    B, S = tokens.shape
    x = L.embed(params["embedding"], tokens, dtype)
    x = x + params["pos_embedding"][:S].to(dtype)[None]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    kvs = []
    for lp, (ck, cv) in zip(params["dec_layers"], cross):
        if _remat(cfg, x):
            x, kv = checkpoint(_dec_layer, lp, x, cfg, positions, ck, cv,
                               use_reentrant=False)
        else:
            x, kv = _dec_layer(lp, x, cfg, positions, ck, cv)
        if return_kv:
            kvs.append(kv)
    x = L.layernorm(params["dec_norm"], x)
    if logit_positions is not None:
        x = x[torch.arange(B, device=x.device), logit_positions.long()]
    logits = L.lm_logits(params["embedding"], x, cfg.logit_softcap)
    if return_aux:
        return logits, (kvs, cross), torch.zeros((), device=x.device)
    return logits, (kvs, cross)


def prefill(params, tokens, cfg: ModelConfig, *, lengths, cache: dict,
            embeddings: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None):
    """Encode the frames and run right-padded prompts, writing their self
    K/V into the first S slots of the dense rows of :func:`init_cache`
    (whose T_enc must be the frames') and the cross K/V whole, in place.
    Returns the (B, V) f32 logits at each row's position ``lengths -
    1``."""
    logits, (kvs, cross) = forward(
        params, tokens, cfg, embeddings=embeddings, frames=frames,
        logit_positions=lengths - 1, return_kv=True)
    S = tokens.shape[1]
    for i, ((k, v), (ck, cv)) in enumerate(zip(kvs, cross)):
        cache["k"][i, :, :S] = k.to(cache["k"].dtype)
        cache["v"][i, :, :S] = v.to(cache["v"].dtype)
        cache["cross_k"][i] = ck.to(cache["cross_k"].dtype)
        cache["cross_v"][i] = cv.to(cache["cross_v"].dtype)
    return logits


def decode_step(params, tokens, cache: dict, cache_len, cfg: ModelConfig):
    """One decode step.  tokens: (B, 1); cache: the dense rows of
    :func:`prefill`; cache_len: (B,) int32 length *after* this token.
    Adds ``pos_embedding[cache_len - 1]``, writes each layer's self K/V at
    slot ``cache_len - 1`` in place, attends over the cached cross K/V,
    and returns the (B, V) f32 next-token logits."""
    dtype = getattr(torch, cfg.dtype)
    x = L.embed(params["embedding"], tokens, dtype)
    pos = (cache_len - 1).long()
    x = x + params["pos_embedding"][pos].to(dtype)[:, None]
    positions = pos[:, None]
    for i, lp in enumerate(params["dec_layers"]):
        x, _ = _dec_layer(lp, x, cfg, positions, cache["cross_k"][i],
                          cache["cross_v"][i],
                          cache={"k": cache["k"][i], "v": cache["v"][i]},
                          cache_len=cache_len)
    x = L.layernorm(params["dec_norm"], x)
    return L.lm_logits(params["embedding"], x[:, 0], cfg.logit_softcap)
