"""Sequence-parallel (flash-decoding style) KV attention.

The dense KV cache is sharded along its *sequence* dim over the mesh axis
``par.kv_seq_axis``: each rank holds its S / n slots (and, when the batch
divides the other batch axes, its rows of them).  Each shard computes a
partial safe-softmax attention (unnormalized out, running max m, running
sum l) over its slice, and the shards combine with the distributed
softmax merge:

    m* = pmax(m);   l* = psum(l e^{m-m*});   o* = psum(o e^{m-m*}) / l*

The merge payload is cast to the cache's dtype before the psum, as the
JAX package does (one fused psum in bf16 under a bf16 cache; the
normalization stays local f32).  Everything outside the attention (the
projections, the FFN or MoE) runs on the global rows, the same on every
rank: the JAX package's global arrays, with the ``shard_map``'s in_specs
and out_specs written out as ``shard_of`` and ``gather_leaf``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (ParallelContext, axes_of,
                                              gather_leaf, shard_of)
from repro_torch.models import layers as L

KV_LEAVES = ("k", "v", "attn_k", "attn_v")


def _seq_shard_attention(q, new_k, new_v, cache_k, cache_v, cache_len,
                         window, *, axis, mesh, softcap: float,
                         ring_size: int = 0):
    """One rank's part.  q, new_k/v, cache_len: this rank's rows; cache_*:
    its (B_loc, S_loc, Hkv, D) block, written in place.  ``ring_size``:
    total ring slots (0 = linear cache)."""
    B, S_loc = cache_k.shape[:2]
    base = C.axis_index(axis, mesh) * S_loc  # global slot of local row 0

    # -- write the current token's K/V into whichever shard owns the slot
    # (a row that does not own its slot writes back what its clamped slot
    # holds: no data-dependent shapes, so it runs on ``meta`` too)
    target = cache_len.long() - 1
    slot = target % ring_size if ring_size else target
    owns = (slot >= base) & (slot < base + S_loc)
    rows = torch.arange(B, device=q.device)
    local = torch.clamp(slot - base, 0, S_loc - 1)
    for cache, new in ((cache_k, new_k), (cache_v, new_v)):
        cache[rows, local] = torch.where(owns[:, None, None],
                                         new[:, 0].to(cache.dtype),
                                         cache[rows, local])

    # -- partial attention over the local slice
    slots = base + torch.arange(S_loc, device=q.device)[None]
    q_pos = target[:, None]
    if ring_size:
        kv_pos = L.ring_slot_positions(slots, cache_len.long()[:, None],
                                       ring_size)
        valid = kv_pos >= 0
    else:
        kv_pos = slots
        valid = kv_pos < cache_len.long()[:, None]
    valid = valid & L._window_ok(q_pos, kv_pos, window)
    o, m, l = L.decode_attention_partial(q, cache_k, cache_v, valid=valid,
                                         softcap=softcap)

    # -- distributed softmax merge, the payload in the cache's dtype
    m_star = C.pmax(m, axis, mesh)
    corr = torch.exp(m - m_star)
    Bq, _, Hq, D = o.shape
    payload = torch.cat(
        [(o * corr[:, None, :, None]).reshape(Bq, Hq * D),
         (l * corr).reshape(Bq, Hq)], dim=-1).to(cache_k.dtype)
    merged = C.psum(payload, axis, mesh).float()
    o_star = merged[:, :Hq * D].reshape(Bq, 1, Hq, D)
    l_star = merged[:, Hq * D:].reshape(Bq, Hq)
    o_star = o_star / torch.clamp_min(l_star[:, None, :, None], 1e-30)
    return o_star.to(q.dtype)


def seq_batch_axes(par: ParallelContext, batch: int):
    """The batch axes of a sequence-parallel decode of ``batch`` rows:
    ``batch_axes_for`` without the sequence axis."""
    batch_ax = par.batch_axes_for(batch)
    bt = tuple(a for a in axes_of(batch_ax) if a != par.kv_seq_axis)
    return bt if len(bt) > 1 else (bt[0] if bt else None)


def shard_cache(cache: dict, par: ParallelContext, batch: int) -> dict:
    """This rank's part of a dense cache that ``prefill`` wrote whole:
    each KV leaf (L or n_apps, B, S, Hkv, D) cut to its rows of
    :func:`seq_batch_axes` and its S / n slots of ``par.kv_seq_axis``
    (copies); the per-row conv / ssm states of a Mamba2 cache stay whole,
    as every rank advances every row."""
    if par.mesh is None or par.kv_seq_axis not in par.axes:
        return cache
    spec = (None, seq_batch_axes(par, batch), par.kv_seq_axis)
    return {k: (shard_of(v, spec, par).clone() if k in KV_LEAVES else v)
            for k, v in cache.items()}


def seq_parallel_attention(q, new_k, new_v, cache_k, cache_v, cache_len,
                           window, cfg: ModelConfig, par: ParallelContext):
    """q: (B, 1, Hq, D), new_k/v: (B, 1, Hkv, D), cache_len: (B,) — the
    global rows; cache_*: this rank's block of the layer's cache
    (:func:`shard_cache`), written in place.  Returns (o (B, 1, Hq, D),
    cache_k, cache_v).  Without a mesh (or without the sequence axis on
    it) the cache is whole and this is the dense decode path, the JAX
    package's single-device semantics."""
    axis = par.kv_seq_axis
    ring = cfg.ring_cache
    if par.mesh is None or axis is None or axis not in par.axes:
        B = q.shape[0]
        S = cache_k.shape[1]
        idx = (cache_len.long() - 1) % S if ring else cache_len.long() - 1
        b_idx = torch.arange(B, device=q.device)
        cache_k[b_idx, idx] = new_k[:, 0].to(cache_k.dtype)
        cache_v[b_idx, idx] = new_v[:, 0].to(cache_v.dtype)
        o = L.decode_attention(q, cache_k, cache_v, cache_len=cache_len,
                               window=window, softcap=cfg.logit_softcap,
                               ring=ring)
        return o, cache_k, cache_v

    vec = (seq_batch_axes(par, q.shape[0]),)
    ring_size = cache_k.shape[1] * C.axis_size(axis, par.mesh) if ring else 0
    o = _seq_shard_attention(
        *(shard_of(t, vec, par) for t in (q, new_k, new_v)), cache_k,
        cache_v, shard_of(cache_len, vec, par), window, axis=axis,
        mesh=par.mesh, softcap=cfg.logit_softcap, ring_size=ring_size)
    return gather_leaf(o, vec, par), cache_k, cache_v


def seq_parallel_decode_layer(lp, x, cfg: ModelConfig, par: ParallelContext,
                              *, cache_k, cache_v, cache_len, window):
    """Full transformer layer for the sequence-parallel decode path.

    Mirrors ``models.transformer._layer`` but routes attention through the
    seq-sharded cache.  Returns (x, cache_k, cache_v)."""
    from repro_torch.models.moe import moe_ffn

    B, S, _ = x.shape
    hd = cfg.resolved_head_dim()
    hn = L.rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
    q = L.linear(lp["attn"]["wq"], hn).reshape(B, S, cfg.n_heads, hd)
    k = L.linear(lp["attn"]["wk"], hn).reshape(B, S, cfg.n_kv_heads, hd)
    v = L.linear(lp["attn"]["wv"], hn).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.rope_theta:
        positions = (cache_len - 1)[:, None]
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
    o, ck, cv = seq_parallel_attention(q, k, v, cache_k, cache_v, cache_len,
                                       window, cfg, par)
    x = x + L.linear(lp["attn"]["wo"], o.reshape(B, S, cfg.n_heads * hd))
    hn = L.rmsnorm(lp["ffn_norm"], x, cfg.norm_eps)
    if cfg.moe:
        h, _ = moe_ffn(lp["moe"], hn, cfg, par)
    else:
        h = L.swiglu(lp["ffn"], hn)
    return x + h, ck, cv
