"""Model building blocks of the dense GQA decoder, as plain functions over
parameter dicts of tensors.

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
    to its single-chunk case (prompts here are shorter than one chunk).
    Returns (B, Sq, Hq, D) in q.dtype."""
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
# Paged decode attention
# ---------------------------------------------------------------------------

PAGED_ATTN_IMPLS = ("exact", "lut")
_PAGED_ATTN_IMPL = os.environ.get("REPRO_TORCH_PAGED_ATTN", "exact")


def set_paged_attention_impl(impl: str) -> str:
    """Select the exp mode of paged decode attention: ``"exact"`` (f32
    online softmax) or ``"lut"`` (the paper's fp16 LUT softmax, Alg. 1).
    Both run the paged-attention kernel on CUDA tensors and its plain
    version on CPU tensors.  Returns the previous impl.  Also selectable
    with the env var ``REPRO_TORCH_PAGED_ATTN``."""
    global _PAGED_ATTN_IMPL
    if impl not in PAGED_ATTN_IMPLS:
        raise ValueError(f"unknown paged-attention impl {impl!r}; "
                         f"expected one of {PAGED_ATTN_IMPLS}")
    prev, _PAGED_ATTN_IMPL = _PAGED_ATTN_IMPL, impl
    return prev


def paged_decode_attention(q, k_pool, v_pool, *, table, cache_len,
                           window: int = 0, softcap: float = 0.0):
    """Single-step attention against a paged KV cache.

    q: (B, 1, Hq, D); pools: per-layer (n_blocks, bs, Hkv, D) tensors or
    quantized {"codes", "scales"} dicts; table: (B, W) int32 block ids;
    cache_len: (B,) int32 including the current token."""
    impl = _PAGED_ATTN_IMPL
    if impl not in PAGED_ATTN_IMPLS:
        raise ValueError(f"unknown paged-attention impl {impl!r}; "
                         f"expected one of {PAGED_ATTN_IMPLS}")
    from repro_torch.kernels import ops

    return ops.paged_flash_decode(q, k_pool, v_pool, table, cache_len,
                                  window=window, softcap=softcap,
                                  exp_mode=impl)


def attention_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor, window: int, cache=None,
                    cache_len=None):
    """Attention block.  Returns (out, (k, v)).

    - prefill (``cache`` None): attention over x itself; returns the
      sequence's rope'd (k, v) for the caller to scatter into the pool.
    - paged decode: ``cache`` = {"k", "v", "table"} with per-layer pool
      leaves (n_blocks, bs, Hkv, D) (or quantized dicts) and a (B, W)
      table; the current token's K/V is quantized if the pool is, written
      **in place** at (table[b, (len-1)//bs], (len-1) % bs), and attention
      walks the table.  A done row arrives with cache_len == W*bs and
      writes to the scratch block or an unattended final offset.
    """
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim()
    q = linear(p["wq"], x).reshape(B, S, cfg.n_heads, hd)
    k = linear(p["wk"], x).reshape(B, S, cfg.n_kv_heads, hd)
    v = linear(p["wv"], x).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.rope_theta:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    if cache is None:
        o = chunked_attention(q, k, v, q_positions=positions,
                              kv_positions=positions, causal=True,
                              window=window, softcap=cfg.logit_softcap)
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


def embed(p: dict, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return p["table"].to(dtype)[tokens.long()]


def lm_logits(p: dict, x: torch.Tensor, softcap: float = 0.0):
    """Tied-embedding LM head with f32 logits (f32 accumulation, as the
    JAX package's ``preferred_element_type``)."""
    table = p["table"].to(x.dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.float32:
        logits = x2 @ table.t()
    else:
        logits = torch.mm(x2, table.t(), out_dtype=torch.float32)
    logits = logits.reshape(*lead, -1)
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    return logits
