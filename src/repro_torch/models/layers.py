"""Model building blocks of the dense GQA decoder and the Whisper
encoder-decoder, as plain functions over parameter dicts of tensors.

Layouts match the JAX package's public functions: activations are
(B, S, H, D), linear weights (in, out), attention heads grouped as
Hq = Hkv × G with query head ``h * G + g`` reading KV head ``h``.
"""
from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

NEG_INF = -1e30


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Dense layer; ``p["w"]`` is an fp (in, out) weight or a quantized
    leaf dict (``repro_torch.quant``)."""
    w = p["w"]
    if isinstance(w, dict):
        from repro_torch.quant.qlinear import quantized_matmul

        y = quantized_matmul(x, w)
    else:
        y = torch.matmul(x, w.to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 (population variance), ``scale`` and ``bias``."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D); positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freq = torch.exp(-math.log(theta) * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freq          # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                 # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _window_ok(q_pos, kv_pos, window: int):
    return (window <= 0) | (q_pos - kv_pos < window)


def chunked_attention(q, k, v, *, q_positions, kv_positions,
                      causal: bool = True, window: int = 0,
                      softcap: float = 0.0) -> torch.Tensor:
    """Prefill attention as plain tensor ops.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); positions (B, S).  Scores
    in f32, masked softmax, probabilities cast to v's dtype for P·V with
    f32 accumulation — the JAX package's chunked online softmax reduced
    to its single-chunk case (its chunks are 512 queries by 1024 keys;
    past them, as over Whisper's 1500 encoder frames, the two differ by
    f32 rounding only).  Returns (B, Sq, Hq, D) in q.dtype."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (1.0 / math.sqrt(D))
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    qp = q_positions[:, :, None]
    kp = kv_positions[:, None, :]
    mask = _window_ok(qp, kp, window)
    if causal:
        mask = mask & (kp <= qp)
    s = torch.where(mask[:, None, None], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())
    o = pv / torch.clamp_min(l, 1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)


# ---------------------------------------------------------------------------
# Decode attention: dense cache rows and the paged pool
# ---------------------------------------------------------------------------


def ring_slot_positions(slots, cache_len, ring_size: int):
    """Token position held by each slot of a ring cache of ``ring_size``
    entries: slot i holds the most recent position p <= cache_len - 1
    with p = i (mod ring_size); p < 0 means the slot is not written yet.
    slots: (..., S) int; cache_len broadcastable against it."""
    last = cache_len - 1
    return last - torch.remainder(last - slots, ring_size)


def decode_attention(q, k_cache, v_cache, *, cache_len, window: int = 0,
                     softcap: float = 0.0, ring: bool = False):
    """Single-step attention against dense KV cache rows.

    q: (B, 1, Hq, D); caches: (B, S, Hkv, D); cache_len: (B,) int32
    including the current token, whose K/V is already written.  ``ring``:
    the cache is a circular buffer of S slots (slot = position % S).
    Scores and softmax in f32, probabilities cast to v's dtype for P.V
    with f32 accumulation, as the JAX package's einsum.  Returns
    (B, 1, Hq, D) in q.dtype."""
    B, _, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) * (
        1.0 / math.sqrt(D))
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    q_pos = (cache_len.long() - 1)[:, None]
    slots = torch.arange(S, device=q.device)[None]
    if ring:
        kv_pos = ring_slot_positions(slots, cache_len.long()[:, None], S)
        valid = kv_pos >= 0
    else:
        kv_pos = slots
        valid = kv_pos < cache_len.long()[:, None]
    valid = valid & _window_ok(q_pos, kv_pos, window)
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, 1, Hq, D).to(q.dtype)


def decode_attention_partial(q, k_cache, v_cache, *, valid,
                             softcap: float = 0.0):
    """One shard's partial decode attention for a sequence-sharded KV
    cache.  q: (B, 1, Hq, D); caches: the shard's (B, S_loc, Hkv, D);
    valid: (B, S_loc) bool.  Returns (o unnormalized f32 (B, 1, Hq, D),
    m (B, Hq), l (B, Hq)) for the distributed safe-softmax merge:
      m* = max_i m_i;  l* = sum_i l_i e^{m_i-m*};  o* = sum_i o_i e^{m_i-m*} / l*.
    A shard with no valid slot gives m = NEG_INF and l = o = 0."""
    B, _, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) * (
        1.0 / math.sqrt(D))
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    mask = valid[:, None, None]
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, 1, Hq, D), m.reshape(B, Hq), l.reshape(B, Hq)


PAGED_ATTN_IMPLS = ("exact", "lut")
# the JAX package's "xla" branch: table gather, the pool's plain dequant,
# f32 softmax in decode_attention.  Selectable only by name through
# set_paged_attention_impl (the profiler's numerics canary); never the
# default, and never what runs when a kernel fails.
PLAIN_IMPL = "plain"
_ENV_IMPL = os.environ.get("REPRO_TORCH_PAGED_ATTN", "exact")
_PAGED_ATTN_IMPL = _ENV_IMPL if _ENV_IMPL in PAGED_ATTN_IMPLS else None


def set_paged_attention_impl(impl: str) -> str:
    """Select the paged decode attention: ``"exact"`` (f32 online
    softmax) or ``"lut"`` (the paper's fp16 LUT softmax, Alg. 1), both
    the paged-attention kernel on CUDA tensors and its plain version on
    CPU tensors; or ``"plain"``, plain tensor ops on any device (the
    canary's exact path).  Returns the previous impl.  ``exact`` and
    ``lut`` are also selectable with the env var
    ``REPRO_TORCH_PAGED_ATTN``."""
    global _PAGED_ATTN_IMPL
    if impl not in PAGED_ATTN_IMPLS + (PLAIN_IMPL,):
        raise ValueError(f"unknown paged-attention impl {impl!r}; "
                         f"expected one of {PAGED_ATTN_IMPLS + (PLAIN_IMPL,)}")
    prev, _PAGED_ATTN_IMPL = _PAGED_ATTN_IMPL, impl
    return prev


def paged_decode_attention(q, k_pool, v_pool, *, table, cache_len,
                           window: int = 0, softcap: float = 0.0):
    """Single-step attention against a paged KV cache.

    q: (B, 1, Hq, D); pools: per-layer (n_blocks, bs, Hkv, D) tensors or
    quantized {"codes", "scales"} dicts; table: (B, W) int32 block ids;
    cache_len: (B,) int32 including the current token."""
    from repro_torch.kernels import ops

    impl = _PAGED_ATTN_IMPL
    if impl == PLAIN_IMPL:
        return _plain_paged_decode_attention(q, k_pool, v_pool, table,
                                             cache_len, window, softcap)
    if impl not in PAGED_ATTN_IMPLS:
        raise ValueError(f"unknown paged-attention impl {_ENV_IMPL!r}; "
                         f"expected one of {PAGED_ATTN_IMPLS}")
    return ops.paged_flash_decode(q, k_pool, v_pool, table, cache_len,
                                  window=window, softcap=softcap,
                                  exp_mode=impl)


def _plain_paged_decode_attention(q, k_pool, v_pool, table, cache_len,
                                  window, softcap):
    """Gather each row's blocks into a contiguous (B, W bs, Hkv, D) view
    (dequantized to f32 by the pool's plain ``dequantize_kv`` on a
    quantized pool) and run :func:`decode_attention`: padding slots point
    at the scratch block and lie past ``cache_len``, so its length mask
    hides them.  Recorded as ``paged_attention_xla``, the JAX package's
    name for the same branch."""
    from repro_torch.kernels import autotune, ops
    from repro_torch.serving.kv_quant import dequantize_kv, pool_block_size

    B, W = table.shape
    bs = pool_block_size(k_pool)
    if ops.op_hook() is not None:
        ops.record_op("paged_attention_xla", *autotune.paged_attn_cost(
            B, q.shape[2], W, bs, q.shape[3],
            slab_bytes=ops.pool_slab_bytes(k_pool),
            q_bytes=q.element_size()))
    idx = table.long()

    def gather(pool):
        if isinstance(pool, dict):
            seq = dequantize_kv({name: a[idx] for name, a in pool.items()})
        else:
            seq = pool[idx]
        return seq.reshape(B, W * bs, *seq.shape[3:])

    return decode_attention(q, gather(k_pool), gather(v_pool),
                            cache_len=cache_len, window=window,
                            softcap=softcap)


def attention_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor, window: int, cache=None,
                    cache_len=None, prefix_kv=None, prefix_positions=None,
                    cross_kv=None, causal: bool = True):
    """Attention block.  Returns (out, (k, v)), or (out, None) for cross
    attention.

    - prefill (``cache`` None): attention over x itself (causal unless
      ``causal=False``, the Whisper encoder's); returns the sequence's
      rope'd (k, v) for the caller to scatter into the pool.
    - cross attention (the Whisper decoder): ``cross_kv`` = (k, v) of
      shape (B, T_enc, Hkv, D), precomputed from the encoder output; only
      q is projected, with no rope and no cache write.  Without ``cache``
      every query attends over all T_enc keys (prefill, training); with
      any ``cache`` (decode) through :func:`decode_attention` at
      ``cache_len`` = T_enc.
    - partial prefill: additionally ``prefix_kv`` = (k, v) of shape
      (B, P, Hkv, D), the already-rope'd KV of a cached prompt prefix, and
      ``prefix_positions`` (B, P), with invalid slots pushed past every
      query position so the causal mask hides them.  ``x`` holds only the
      uncached suffix (its ``positions`` start at each row's cached
      length); queries attend over prefix + suffix, and only the suffix's
      (k, v) is returned.  Rows may carry different cached lengths.
    - paged decode: ``cache`` = {"k", "v", "table"} with per-layer pool
      leaves (n_blocks, bs, Hkv, D) (or quantized dicts) and a (B, W)
      table; the current token's K/V is quantized if the pool is, written
      **in place** at (table[b, (len-1)//bs], (len-1) % bs), and attention
      walks the table.  A done row arrives with cache_len == W*bs and
      writes to the scratch block or an unattended final offset.
    - dense decode: ``cache`` = {"k", "v"} per-layer rows (B, S, Hkv, D);
      the current token's K/V is written **in place** at slot len - 1
      (``(len - 1) % S`` on a ring cache) and attention reads the rows.
      A done row arrives with cache_len == S and writes to the last slot,
      the scratch slot no live row attends.
    """
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim()
    q = linear(p["wq"], x).reshape(B, S, cfg.n_heads, hd)
    if cross_kv is not None:
        k, v = cross_kv
        T = k.shape[1]
        if cache is None:
            kv_pos = torch.arange(T, device=x.device)[None].expand(B, T)
            o = chunked_attention(q, k, v, q_positions=positions,
                                  kv_positions=kv_pos, causal=False,
                                  window=0, softcap=cfg.logit_softcap)
        else:
            o = decode_attention(q, k, v, cache_len=torch.full(
                (B,), T, dtype=torch.int32, device=x.device),
                softcap=cfg.logit_softcap)
        return linear(p["wo"], o.reshape(B, S, cfg.n_heads * hd)), None
    k = linear(p["wk"], x).reshape(B, S, cfg.n_kv_heads, hd)
    v = linear(p["wv"], x).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.rope_theta:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    if cache is None and prefix_kv is not None:
        pk, pv = prefix_kv
        kv_pos = torch.cat([prefix_positions, positions.expand(B, S)], dim=1)
        o = chunked_attention(q, torch.cat([pk.to(k.dtype), k], dim=1),
                              torch.cat([pv.to(v.dtype), v], dim=1),
                              q_positions=positions, kv_positions=kv_pos,
                              causal=True, window=window,
                              softcap=cfg.logit_softcap)
    elif cache is None:
        o = chunked_attention(q, k, v, q_positions=positions,
                              kv_positions=positions, causal=causal,
                              window=window, softcap=cfg.logit_softcap)
    elif "table" not in cache:
        ring = cfg.ring_cache
        S_cache = cache["k"].shape[1]
        idx = (cache_len.long() - 1) % S_cache if ring else \
            cache_len.long() - 1
        b_idx = torch.arange(B, device=x.device)
        for rows, new in ((cache["k"], k), (cache["v"], v)):
            rows[b_idx, idx] = new[:, 0].to(rows.dtype)
        o = decode_attention(q, cache["k"], cache["v"], cache_len=cache_len,
                             window=window, softcap=cfg.logit_softcap,
                             ring=ring)
    else:
        from repro_torch.serving.kv_quant import (pool_block_size,
                                                  quantize_for_pool)

        table = cache["table"]
        bs = pool_block_size(cache["k"])
        idx = (cache_len - 1).long()
        b_idx = torch.arange(B, device=x.device)
        blk = table[b_idx, idx // bs].long()
        off = idx % bs
        for pool, new in ((cache["k"], k), (cache["v"], v)):
            payload = quantize_for_pool(new[:, 0], pool)
            if isinstance(pool, dict):
                for name in ("codes", "scales"):
                    pool[name][blk, off] = payload[name].to(pool[name].dtype)
            else:
                pool[blk, off] = payload.to(pool.dtype)
        o = paged_decode_attention(q, cache["k"], cache["v"], table=table,
                                   cache_len=cache_len, window=window,
                                   softcap=cfg.logit_softcap)
    out = linear(p["wo"], o.reshape(B, S, cfg.n_heads * hd))
    return out, (k, v)


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    return linear(p["down"], F.silu(linear(p["gate"], x)) * linear(p["up"], x))


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Whisper's FFN: fc1, GELU (the tanh form, ``jax.nn.gelu``'s
    default), fc2, with biases."""
    return linear(p["fc2"], F.gelu(linear(p["fc1"], x), approximate="tanh"))


def embed(p: dict, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return p["table"].to(dtype)[tokens.long()]


def lm_logits(p: dict, x: torch.Tensor, softcap: float = 0.0):
    """Tied-embedding LM head with f32 logits (f32 accumulation, as the
    JAX package's ``preferred_element_type``).  Under autograd a low
    precision product runs as the f32 product of the same rounded
    operands (``mm``'s ``out_dtype`` form has no CPU kernel and no sure
    backward)."""
    table = p["table"].to(x.dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.float32:
        logits = x2 @ table.t()
    elif x2.requires_grad or table.requires_grad:
        logits = x2.float() @ table.float().t()
    else:
        logits = torch.mm(x2, table.t(), out_dtype=torch.float32)
    logits = logits.reshape(*lead, -1)
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    return logits
