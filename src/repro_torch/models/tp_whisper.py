"""The Whisper encoder-decoder on the per-device layout
(``models.tensor_parallel``): every encoder and decoder layer computes
from the rank's ``model`` block of each weight and cache leaf, the
counterpart of ``models.whisper`` on one device.

Self-attention, cross-attention and the ``fc1`` / ``fc2`` MLP run
column- and row-parallel (``tensor_parallel.attention``,
``row_parallel``): the ``w[qkv]`` and ``fc1`` biases are the rank's
blocks and go with its columns, the replicated ``fc2`` bias is added
once after the sum over ``model``.  The LayerNorms, ``frame_proj`` and
``pos_embedding`` (no rule, so whole) are replicated.  The encoder's
residual is sequence-sharded under ``shard_activations_seq`` only where
its frames split over ``model`` (1,500 do not on 16).

The cache leaves "k", "v", "cross_k", "cross_v" (L, B, S, Hkv, hd) are
the rank's blocks as ``configs.inputs.cache_specs`` splits them
(:func:`layout`):

- ``heads``: the rank's heads, which are the ones it computes;
- ``dims``: where the heads do not divide ``model`` (whisper-base's 8 on
  16), dims [r e, (r + 1) e) of every head, e = hd / m.  A prefill
  computes whole heads on the rank of their first column and moves each
  one's dims to the ranks that keep them (``collectives.regroup``).  A
  decode step fetches the rank's dims of every head of q, k and v, takes
  partial q.k over them, a ``psum`` of the scores over ``model``, the
  softmax, and P.V on its dims, then moves the output's columns to the
  rank's rows of ``wo``: it never gathers the cache;
- ``whole``: neither divides; every rank keeps every head.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import shard_of
from repro_torch.models import layers as L
from repro_torch.models import tensor_parallel as TP
from repro_torch.models import whisper as W
from repro_torch.models.tensor_parallel import TPLayout


def layout(cfg: ModelConfig, m: int) -> str:
    """How ``configs.inputs.cache_specs`` splits the KV leaves over a
    ``model`` axis of ``m``: "heads", "dims" or "whole"."""
    if cfg.n_kv_heads % m == 0:
        return "heads"
    return "dims" if cfg.resolved_head_dim() % m == 0 else "whole"


def _dims(cfg: ModelConfig, m: int) -> list:
    """Per rank, the columns of its dims of every head (``dims``)."""
    H, hd = cfg.n_heads, cfg.resolved_head_dim()
    e = hd // m
    return [tuple((h * hd + r * e, h * hd + (r + 1) * e) for h in range(H))
            for r in range(m)]


def _to_cache(k, cfg: ModelConfig, tp: TPLayout):
    """(B, T, h, hd) of the kv heads the rank read, as the rank's block of
    a cache leaf (:func:`layout`)."""
    lay = layout(cfg, tp.m)
    if lay == "heads":
        return k
    _, own = TP._q_plan(cfg, tp.m)  # the kv heads read are the q heads
    B, T = k.shape[:2]
    H, hd = cfg.n_heads, cfg.resolved_head_dim()
    want = _dims(cfg, tp.m) if lay == "dims" else [(0, H * hd)] * tp.m
    if own == want:
        return k
    y = C.regroup(k.reshape(B, T, -1), own, want, "model", tp.mesh, dim=2)
    return y.view(B, T, H, -1)


def _mlp(p: dict, h, cfg: ModelConfig, tp: TPLayout):
    """fc1 (the rank's columns and bias block), GELU, row-parallel fc2."""
    a = F.gelu(L.linear(p["fc1"], h), approximate="tanh")
    return TP.row_parallel(p["fc2"], a, cfg.d_ff, tp)


def _enc_layer(lp, x, cfg, tp, positions):
    h = TP._whole_seq(L.layernorm(lp["attn_norm"], x), tp)
    y, _ = TP.attention(lp["attn"], h, cfg, tp, positions=positions,
                        window=0, aligned=False, causal=False)
    x = x + y
    h = TP._whole_seq(L.layernorm(lp["mlp_norm"], x), tp)
    return x + _mlp(lp["mlp"], h, cfg, tp)


def encode(params, frames, cfg: ModelConfig, tp: TPLayout):
    """frames: (B, T_enc, d_model) stub embeddings -> (B, T_enc, d), whole
    on every ``model`` rank."""
    dtype = getattr(torch, cfg.dtype)
    x = L.linear(params["frame_proj"], frames.to(dtype))
    x = x + W._sinusoids(x.shape[1], cfg.d_model, x.device).to(dtype)[None]
    B, T = x.shape[:2]
    if tp.seq and T % tp.m:
        tp = tp.whole_residual()
    if tp.seq:
        x = shard_of(x, (None, "model"), tp.par)
    positions = torch.arange(T, dtype=torch.int32,
                             device=x.device)[None].expand(B, T)
    for lp in params["enc_layers"]:
        if W._remat(cfg, x):
            x = checkpoint(_enc_layer, lp, x, cfg, tp, positions,
                           use_reentrant=False)
        else:
            x = _enc_layer(lp, x, cfg, tp, positions)
    return TP._whole_seq(L.layernorm(params["enc_norm"], x), tp)


def _dec_layer(lp, x, cfg, tp, positions, cross):
    h = TP._whole_seq(L.layernorm(lp["attn_norm"], x), tp)
    y, kv = TP.attention(lp["attn"], h, cfg, tp, positions=positions,
                         window=0, aligned=True)
    x = x + y
    h = TP._whole_seq(L.layernorm(lp["cross_norm"], x), tp)
    y, _ = TP.attention(lp["cross"], h, cfg, tp, positions=positions,
                        window=0, aligned=False, cross=cross)
    x = x + y
    h = TP._whole_seq(L.layernorm(lp["mlp_norm"], x), tp)
    return x + _mlp(lp["mlp"], h, cfg, tp), kv


def _train_dec(lp, x, cfg, tp, positions, ck, cv):
    return _dec_layer(lp, x, cfg, tp, positions, (ck, cv))[0]


def forward(params, tokens, cfg: ModelConfig, tp: TPLayout, *,
            embeddings=None, frames=None, logit_positions=None,
            cache: Optional[dict] = None):
    """Teacher-forced decoder over the encoded frames on this rank's rows.
    Returns (logits, aux): the rank's vocab block of the f32 logits (B, S,
    V / m) or at ``logit_positions`` (B, V / m) (the whole vocab where the
    table does not divide ``model``), and a zero auxiliary loss.
    ``cache`` (:func:`init_cache`): each layer writes its self (k, v) of
    the first S slots and its cross (k, v) as the rank's blocks, in
    place."""
    if frames is None:
        frames = embeddings
    if frames is None:
        raise ValueError("the encdec family needs frame embeddings "
                         "(embeddings=, (B, T_enc, d_model))")
    enc = encode(params, frames, cfg, tp)
    cross = [TP.kv_heads(lp["cross"], enc, cfg, tp)
             for lp in params["dec_layers"]]
    dtype = getattr(torch, cfg.dtype)
    B, S = tokens.shape
    x = TP.embed(params["embedding"], tokens, cfg, dtype, tp, scatter=tp.seq)
    pos = params["pos_embedding"][:S].to(dtype)[None]
    x = x + (shard_of(pos, (None, "model"), tp.par) if tp.seq else pos)
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    for i, (lp, (ck, cv)) in enumerate(zip(params["dec_layers"], cross)):
        if W._remat(cfg, x) and cache is None:
            x = checkpoint(_train_dec, lp, x, cfg, tp, positions, ck, cv,
                           use_reentrant=False)
            continue
        x, (k, v) = _dec_layer(lp, x, cfg, tp, positions, (ck, cv))
        if cache is not None:
            for name, t in (("k", k), ("v", v), ("cross_k", ck),
                            ("cross_v", cv)):
                t = _to_cache(t, cfg, tp).to(cache[name].dtype)
                if name in ("k", "v"):
                    cache[name][i, :, :S] = t
                else:
                    cache[name][i] = t
    x = TP._whole_seq(L.layernorm(params["dec_norm"], x), tp)
    if logit_positions is not None:
        x = x[torch.arange(B, device=x.device), logit_positions.long()]
    logits = L.lm_logits(params["embedding"], x, cfg.logit_softcap)
    return logits, torch.zeros((), device=x.device)


def init_cache(cfg: ModelConfig, tp: TPLayout, batch: int, max_len: int,
               dtype=None, *, t_enc: int = 0, device) -> dict:
    """Zeroed rank's blocks of the dense rows (:func:`layout`): self K/V
    (L, batch, max_len, Hkv', hd') and cross K/V (L, batch, t_enc, Hkv',
    hd'), t_enc defaulting to ``cfg.encoder_seq_len``."""
    dtype = dtype or getattr(torch, cfg.dtype)
    hd, Hkv, m = cfg.resolved_head_dim(), cfg.n_kv_heads, tp.m
    lay = layout(cfg, m)
    heads = (Hkv // m, hd) if lay == "heads" else \
        (Hkv, hd // m) if lay == "dims" else (Hkv, hd)
    t_enc = t_enc or cfg.encoder_seq_len
    shape = (cfg.n_layers, batch, max_len) + heads
    xshape = (cfg.n_layers, batch, t_enc) + heads
    return {name: torch.zeros(s, dtype=dtype, device=device)
            for name, s in (("k", shape), ("v", shape), ("cross_k", xshape),
                            ("cross_v", xshape))}


def prefill(params, tokens, cfg: ModelConfig, tp: TPLayout, *, lengths,
            cache: dict, embeddings=None, frames=None):
    """Encode the frames and run right-padded prompts over this rank's
    rows, writing the rank's blocks of their self K/V (first S slots) and
    cross K/V into ``cache`` (:func:`init_cache`) in place.  Returns the
    rank's vocab block of the (B, V) logits at ``lengths - 1``."""
    logits, _ = forward(params, tokens, cfg, tp, embeddings=embeddings,
                        frames=frames, logit_positions=lengths - 1,
                        cache=cache)
    return logits


def _decode_attention(p: dict, h, cfg: ModelConfig, tp: TPLayout, *,
                      cache_k, cache_v, cache_len, new_kv: bool):
    """One query row's attention over the rank's block of a KV leaf (the
    new token's K/V written first at ``cache_len - 1`` when ``new_kv``),
    then the row-parallel ``wo``.  h: (B, 1, d) whole."""
    B = h.shape[0]
    H, hd = cfg.n_heads, cfg.resolved_head_dim()
    lay = layout(cfg, tp.m)
    b_idx = torch.arange(B, device=h.device)
    idx = cache_len.long() - 1

    def proj(w):
        y = L.linear(p[w], h)
        if lay == "heads":
            return y.view(B, 1, -1, hd)
        if lay == "dims":
            return TP.take(y, H * hd, _dims(cfg, tp.m), tp).view(B, 1, H, -1)
        return TP._all_heads(y, H, hd, tp)

    q = proj("wq")
    if new_kv:
        for rows, w in ((cache_k, "wk"), (cache_v, "wv")):
            rows[b_idx, idx] = proj(w)[:, 0].to(rows.dtype)
    if lay != "dims":
        o = L.decode_attention(q, cache_k, cache_v, cache_len=cache_len,
                               softcap=cfg.logit_softcap)
        o = o.reshape(B, 1, -1)
        if lay == "whole" and TP._sharded(TP.in_features(p["wo"]), H * hd,
                                          tp):
            n = TP.in_features(p["wo"])
            o = o.narrow(-1, tp.r * n, n)
        return TP.row_parallel(p["wo"], o, H * hd, tp)
    # dims: partial scores over the rank's dims of every head, summed
    s = torch.einsum("bhd,bkhd->bhk", q[:, 0].float(), cache_k.float())
    s = C.psum(s, "model", tp.mesh) * (1.0 / math.sqrt(hd))
    if cfg.logit_softcap:
        s = torch.tanh(s / cfg.logit_softcap) * cfg.logit_softcap
    valid = torch.arange(cache_k.shape[1], device=h.device)[None] < \
        cache_len.long()[:, None]
    s = torch.where(valid[:, None], s, L.NEG_INF)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bhk,bkhd->bhd", pr.to(cache_v.dtype).float(),
                     cache_v.float()).to(q.dtype).reshape(B, 1, -1)
    n = TP.in_features(p["wo"])
    want = TP.blocks(H * hd, tp.m) if TP._sharded(n, H * hd, tp) else \
        [(0, H * hd)] * tp.m
    o = C.regroup(o, _dims(cfg, tp.m), want, "model", tp.mesh, dim=2)
    return TP.row_parallel(p["wo"], o, H * hd, tp)


def decode_step(params, tokens, cache: dict, cache_len, cfg: ModelConfig,
                tp: TPLayout):
    """One decode step over this rank's rows: tokens (B, 1), cache_len
    (B,) and the rank's blocks of the dense cache (:func:`init_cache`),
    the self K/V written at ``cache_len - 1`` in place.  Returns the
    rank's vocab block of the (B, V) f32 logits."""
    dtype = getattr(torch, cfg.dtype)
    x = TP.embed(params["embedding"], tokens, cfg, dtype, tp, scatter=False)
    pos = (cache_len - 1).long()
    x = x + params["pos_embedding"][pos].to(dtype)[:, None]
    B = tokens.shape[0]
    for i, lp in enumerate(params["dec_layers"]):
        h = L.layernorm(lp["attn_norm"], x)
        x = x + _decode_attention(lp["attn"], h, cfg, tp,
                                  cache_k=cache["k"][i],
                                  cache_v=cache["v"][i],
                                  cache_len=cache_len, new_kv=True)
        h = L.layernorm(lp["cross_norm"], x)
        T = cache["cross_k"].shape[2]
        x = x + _decode_attention(
            lp["cross"], h, cfg, tp, cache_k=cache["cross_k"][i],
            cache_v=cache["cross_v"][i], new_kv=False,
            cache_len=torch.full((B,), T, dtype=torch.int32,
                                 device=x.device))
        h = L.layernorm(lp["mlp_norm"], x)
        x = x + _mlp(lp["mlp"], h, cfg, tp)
    x = L.layernorm(params["dec_norm"], x)
    return L.lm_logits(params["embedding"], x[:, 0], cfg.logit_softcap)
