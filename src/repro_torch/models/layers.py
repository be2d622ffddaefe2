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


# ---------------------------------------------------------------------------
# Chunked online-softmax attention (prefill, training, the Whisper encoder
# and cross attention)
# ---------------------------------------------------------------------------

# padded kv slots take a position past every reachable one (not 0: callers
# pass semantic positions, and a 0 would alias the real position 0)
KV_PAD_POSITION = (2 ** 31 - 1) // 2


class _Geometry:
    """Shapes and chunking of one call: q (B, Sq, Hq, D), k/v (B, Skv,
    Hkv, D), chunks of ``qc`` queries by ``kc`` keys, the last of each cut
    short and padded (zero q rows, zero kv rows at ``KV_PAD_POSITION``)."""

    def __init__(self, q, k, q_chunk, kv_chunk):
        self.B, self.Sq, self.Hq, self.D = q.shape
        self.Skv, self.Hkv = k.shape[1], k.shape[2]
        self.G = self.Hq // self.Hkv
        self.qc = min(q_chunk, self.Sq)
        self.kc = min(kv_chunk, self.Skv)
        self.nq = -(-self.Sq // self.qc)
        self.nkv = -(-self.Skv // self.kc)
        self.scale = 1.0 / math.sqrt(self.D)

    def visible(self, i: int, j: int, causal: bool, aligned: bool) -> bool:
        """Whether kv chunk j can hold a key that q chunk i sees.  Known
        only for ``aligned`` causal calls (both positions are arange):
        then chunk j is hidden when its first position lies past the
        chunk's last query.  Chunk 0 holds position 0, so a row reaching
        a hidden chunk already has a finite running max, and the chunk
        would add exactly 0 to its sums."""
        if not (causal and aligned):
            return True
        return j * self.kc <= min((i + 1) * self.qc, self.Sq) - 1

    def tiles(self, causal: bool, aligned: bool) -> int:
        return sum(self.visible(i, j, causal, aligned)
                   for i in range(self.nq) for j in range(self.nkv))


def _chunk(x, i: int, n: int, dim: int = 1, value=0):
    """Chunk ``i`` of length ``n`` along ``dim``, the last padded to ``n``
    with ``value``."""
    part = x.narrow(dim, i * n, min(n, x.shape[dim] - i * n))
    short = n - part.shape[dim]
    if not short:
        return part
    pad = [0, 0] * (x.dim() - 1 - dim) + [0, short]
    return F.pad(part, pad, value=value)


def _q_tile(q, geo, i):
    """Queries of chunk i as (B, Hkv, G qc, D) f32."""
    qi = _chunk(q, i, geo.qc).reshape(geo.B, geo.qc, geo.Hkv, geo.G, geo.D)
    return qi.permute(0, 2, 3, 1, 4).reshape(
        geo.B, geo.Hkv, geo.G * geo.qc, geo.D).float()


def _kv_tile(x, geo, j):
    """Keys or values of chunk j as (B, Hkv, kc, D) f32."""
    return _chunk(x, j, geo.kc).permute(0, 2, 1, 3).float()


def _tile_scores(qi, kj, qp, kp, geo, causal, window, softcap, kv_len):
    """The masked f32 scores of one tile, (B, Hkv, G, qc, kc), and the
    tanh of the softcap (None without one) for the backward."""
    s = torch.matmul(qi, kj.transpose(-1, -2)).mul_(geo.scale)
    s = s.view(geo.B, geo.Hkv, geo.G, geo.qc, geo.kc)
    th = None
    if softcap:
        th = torch.tanh(s / softcap)
        s = th * softcap
    qp, kp = qp[:, :, None], kp[:, None, :]
    mask = None
    if window > 0:
        mask = qp - kp < window
    if causal:
        mask = kp <= qp if mask is None else mask.logical_and_(kp <= qp)
    if kv_len is not None:
        ok = kp < kv_len[:, None, None]
        mask = ok if mask is None else mask.logical_and_(ok)
    if mask is not None:
        s.masked_fill_(mask.logical_not_()[:, None, None], NEG_INF)
    return s, th


def _kv_len(geo, device):
    """The kv length mask the JAX package applies when it pads kv: Skv
    for every row (None without padding)."""
    if geo.Skv % geo.kc == 0:
        return None
    return torch.full((geo.B,), geo.Skv, dtype=torch.long, device=device)


def _forward_loop(q, k, v, qpos, kvpos, kv_len, geo, opts):
    """The double loop.  Returns (o (B, Sq, Hq, D) in q's dtype, lse (B,
    Hkv, G, nq qc) f32: each row's m + log l)."""
    causal, window, softcap, aligned = opts
    B, Hkv, G, qc, D = geo.B, geo.Hkv, geo.G, geo.qc, geo.D
    out = q.new_empty((B, geo.Sq, geo.Hq, D))
    lse = torch.empty((B, Hkv, G, geo.nq * qc), dtype=torch.float32,
                      device=q.device)
    for i in range(geo.nq):
        qi = _q_tile(q, geo, i)
        qp = _chunk(qpos, i, qc)
        o = torch.zeros((B, Hkv, G * qc, D), dtype=torch.float32,
                        device=q.device)
        m = torch.full((B, Hkv, G, qc), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        for j in range(geo.nkv):
            if not geo.visible(i, j, causal, aligned):
                continue
            kp = _chunk(kvpos, j, geo.kc, value=KV_PAD_POSITION)
            s, _ = _tile_scores(qi, _kv_tile(k, geo, j), qp, kp, geo,
                                causal, window, softcap, kv_len)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = s.sub_(m_new[..., None]).exp_()
            corr = torch.exp(m - m_new)
            l.mul_(corr).add_(p.sum(dim=-1))
            if v.dtype != torch.float32:  # P.V reads p in v's dtype
                p.copy_(p.to(v.dtype))
            o.mul_(corr.view(B, Hkv, G * qc, 1))
            o.add_(torch.matmul(p.view(B, Hkv, G * qc, geo.kc),
                                _kv_tile(v, geo, j)))
            m = m_new
            del s, p  # the next tile's scores replace this one's
        o = o.view(B, Hkv, G, qc, D) / torch.clamp_min(l, 1e-30)[..., None]
        n = min(qc, geo.Sq - i * qc)  # the padded rows are dropped
        out[:, i * qc:i * qc + n] = o[:, :, :, :n].permute(
            0, 3, 1, 2, 4).reshape(B, n, geo.Hq, D).to(q.dtype)
        lse[..., i * qc:(i + 1) * qc] = m + torch.log(l)
    return out, lse


def _backward_loop(q, k, v, o, do, lse, qpos, kvpos, kv_len, geo, opts):
    """Gradients by recomputing each tile from q, k, v and the rows'
    logsumexp: p = exp(s - lse), dv += p^T do, dp = do v^T, ds = p (dp -
    delta) with delta = rowsum(do o), through the softcap's tanh, then dq
    += ds k and dk += ds^T q (both scaled).  Holds one tile's scores and
    one of its products at a time."""
    causal, window, softcap, aligned = opts
    B, Hkv, G, qc, kc, D = geo.B, geo.Hkv, geo.G, geo.qc, geo.kc, geo.D
    dq = torch.empty((B, geo.Sq, geo.Hq, D), dtype=q.dtype,
                     device=q.device)
    dk = torch.zeros((B, Hkv, geo.nkv * kc, D), dtype=torch.float32,
                     device=q.device)
    dv = torch.zeros_like(dk)
    for i in range(geo.nq):
        qi = _q_tile(q, geo, i)
        doi = _q_tile(do, geo, i)
        delta = (doi * _q_tile(o, geo, i)).sum(-1).view(B, Hkv, G, qc)
        lsei = lse[..., i * qc:(i + 1) * qc]
        qp = _chunk(qpos, i, qc)
        dqi = torch.zeros_like(qi)
        for j in range(geo.nkv):
            if not geo.visible(i, j, causal, aligned):
                continue
            kp = _chunk(kvpos, j, kc, value=KV_PAD_POSITION)
            kj, vj = _kv_tile(k, geo, j), _kv_tile(v, geo, j)
            s, th = _tile_scores(qi, kj, qp, kp, geo, causal, window,
                                 softcap, kv_len)
            p = s.sub_(lsei[..., None]).exp_()
            # dV reads p as P.V did, in v's dtype (a rounded f32 copy)
            pv = p if v.dtype == torch.float32 else p.to(v.dtype).float()
            dv[:, :, j * kc:(j + 1) * kc] += torch.matmul(
                pv.view(B, Hkv, G * qc, kc).transpose(-1, -2), doi)
            del pv
            dp = torch.matmul(doi, vj.transpose(-1, -2)).view_as(p)
            ds = dp.sub_(delta[..., None]).mul_(p)
            del p, s
            if th is not None:
                ds.mul_(1.0 - th * th)
                del th
            ds = ds.view(B, Hkv, G * qc, kc).mul_(geo.scale)
            dqi += torch.matmul(ds, kj)
            dk[:, :, j * kc:(j + 1) * kc] += torch.matmul(
                ds.transpose(-1, -2), qi)
            del ds, dp
        n = min(qc, geo.Sq - i * qc)
        dq[:, i * qc:i * qc + n] = dqi.view(B, Hkv, G, qc, D)[
            :, :, :, :n].permute(0, 3, 1, 2, 4).reshape(
            B, n, geo.Hq, D).to(q.dtype)
    dk = dk[:, :, :geo.Skv].permute(0, 2, 1, 3).to(k.dtype)
    dv = dv[:, :, :geo.Skv].permute(0, 2, 1, 3).to(v.dtype)
    return dq, dk, dv


def chunked_attention_cost(geo: _Geometry, causal: bool, aligned: bool,
                           itemsize: int, *, backward: bool = False):
    """(flops, bytes) of the loop: two products per tile forward (scores
    and P.V), five backward (scores again, dV, dP, dQ, dK); bytes the
    operands read once per tile they enter and the f32 tile passes of the
    eager ops (about 8 forward, 12 backward)."""
    tiles = geo.tiles(causal, aligned)
    per = 2.0 * geo.B * geo.Hq * geo.qc * geo.kc * geo.D
    tile_bytes = 4 * geo.B * geo.Hq * geo.qc * geo.kc
    q_bytes = geo.B * geo.qc * geo.Hq * geo.D * itemsize
    kv_bytes = 2 * geo.B * geo.kc * geo.Hkv * geo.D * itemsize
    if backward:
        return (5 * per * tiles,
                float(tiles * (12 * tile_bytes + kv_bytes)
                      + geo.nq * 4 * q_bytes + 2 * geo.nkv * kv_bytes))
    return (2 * per * tiles,
            float(tiles * (8 * tile_bytes + kv_bytes) + geo.nq * 2 * q_bytes))


def chunked_attention_workspace(geo: _Geometry, itemsize: int, *,
                                backward: bool = False) -> int:
    """Bytes the loop holds at its peak besides its inputs and what it
    returns.  Forward: one f32 score tile (p in place of it), the rows'
    logsumexp, the q chunk, the (o, m, l) carry with the new max and the
    correction, one kv chunk, the chunk's P.V; in a narrower v dtype p's
    rounded copy, which is live before the kv chunk and P.V are.
    Backward: the p and dP tiles (in a narrower v dtype p's rounded f32
    copy and its v-dtype step first, 2.5 tiles), the q, dO and dQ chunks,
    a kv chunk pair and one product's kv chunk, the rows' delta, and the
    f32 dK, dV accumulators unless they are the returned grads (f32).
    A softcap adds its tanh tile (no config of the registry has one).
    The dry-run allocates this on ``meta`` so its temp counts it."""
    B, Hkv, G, qc, kc, D = geo.B, geo.Hkv, geo.G, geo.qc, geo.kc, geo.D
    tile = 4 * B * Hkv * G * qc * kc
    rows = 4 * B * Hkv * G * qc
    qf = rows * D
    kvf = 4 * B * Hkv * kc * D
    narrow = itemsize != 4
    if not backward:
        ws = tile + rows * geo.nq + 3 * qf + 6 * rows + 2 * kvf
        if narrow:
            ws += tile * itemsize // 4 - qf - kvf
        return ws
    ws = 2 * tile + 3 * qf + 3 * kvf + 2 * rows
    if narrow:
        ws += tile // 2 + 2 * 4 * B * Hkv * geo.nkv * kc * D
    return ws


class _ChunkedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_positions, geo, opts):
        qpos = q_positions.expand(geo.B, geo.Sq).long()
        kvpos = kv_positions.expand(geo.B, geo.Skv).long()
        o, lse = _forward_loop(q, k, v, qpos, kvpos, _kv_len(geo, q.device),
                               geo, opts)
        ctx.save_for_backward(q, k, v, o, lse, qpos, kvpos)
        ctx.args = (geo, opts)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, qpos, kvpos = ctx.saved_tensors
        geo, opts = ctx.args
        dq, dk, dv = _backward_loop(q, k, v, o, do.contiguous(), lse, qpos,
                                    kvpos, _kv_len(geo, q.device), geo, opts)
        return dq, dk, dv, None, None, None, None


class _MetaChunkedAttention(torch.autograd.Function):
    """The loop on ``meta`` (the dry-run) as one op: an empty output, the
    loop's cost to the op hook, its working set allocated and released so
    the dry-run's live-storage meter sees the peak.  Backward likewise."""

    @staticmethod
    def forward(ctx, q, k, v, geo, opts):
        ctx.args = (geo, opts, q.shape, k.shape, q.dtype, k.dtype)
        out = q.new_empty(q.shape)
        _meta_tile_set(geo, opts, q.element_size(), backward=False)
        return out

    @staticmethod
    def backward(ctx, do):
        geo, opts, qs, ks, qd, kd = ctx.args
        grads = (do.new_empty(qs, dtype=qd), do.new_empty(ks, dtype=kd),
                 do.new_empty(ks, dtype=kd))
        _meta_tile_set(geo, opts, do.element_size(), backward=True)
        return (*grads, None, None)


def _meta_tile_set(geo, opts, itemsize, *, backward):
    from repro_torch.kernels import ops

    causal, _, _, aligned = opts
    if ops.op_hook() is not None:
        ops.record_op("chunked_attention_bwd" if backward
                      else "chunked_attention",
                      *chunked_attention_cost(geo, causal, aligned, itemsize,
                                              backward=backward))
    ws = torch.empty(chunked_attention_workspace(geo, itemsize,
                                                 backward=backward),
                     dtype=torch.uint8, device="meta")
    del ws


def chunked_attention(q, k, v, *, q_positions, kv_positions,
                      causal: bool = True, window: int = 0,
                      softcap: float = 0.0, q_chunk: int = 512,
                      kv_chunk: int = 1024,
                      aligned: bool = False) -> torch.Tensor:
    """Flash-style attention as plain tensor ops: a loop over q chunks
    and, inside, over kv chunks, with an f32 online softmax; the JAX
    package's double scan (``repro.models.layers.chunked_attention``).

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); positions (B, S) or
    broadcastable.  Scores in f32 (softcapped, masked to ``NEG_INF`` by
    causality and ``window``), a running (o, m, l) in f32, p cast to v's
    dtype for P.V with f32 accumulation, o / max(l, 1e-30).  The last
    chunk of each side is padded: zero q rows, sliced off the output;
    zero kv rows at ``KV_PAD_POSITION``, masked with every position at or
    past Skv by the kv length the JAX package sets when it pads.  Never
    holds more than one (B, Hkv, G, q_chunk, kv_chunk) f32 score tile
    (and its exp, in place) at a time, forward or backward: the backward
    recomputes each tile from q, k, v and the rows' logsumexp, the
    pattern of the JAX package's ``jax.checkpoint`` per kv block.

    ``aligned``: q_positions and kv_positions are both arange(S) rows
    (the plain prefill and training), so a causal call skips the kv
    chunks wholly past a q chunk (:meth:`_Geometry.visible`); the
    skipped chunks would add exactly 0.

    On ``meta`` (the dry-run) the loop is costed as one op
    (``_MetaChunkedAttention``).  Returns (B, Sq, Hq, D) in q's dtype."""
    geo = _Geometry(q, k, q_chunk, kv_chunk)
    opts = (causal, window, softcap, aligned)
    if q.device.type == "meta":
        return _MetaChunkedAttention.apply(q, k, v, geo, opts)
    return _ChunkedAttention.apply(q, k, v, q_positions, kv_positions, geo,
                                   opts)


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


def paged_attention_impl() -> str | None:
    """The selected paged decode attention (None: an unknown name in
    ``REPRO_TORCH_PAGED_ATTN``, which the first call raises on)."""
    return _PAGED_ATTN_IMPL


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
                    cross_kv=None, causal: bool = True,
                    aligned: bool = False):
    """Attention block.  Returns (out, (k, v)), or (out, None) for cross
    attention.  ``aligned``: ``positions`` are arange(S) rows (a plain
    prefill or training), so the causal chunked attention skips hidden
    chunks (:func:`chunked_attention`).

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
                              window=window, softcap=cfg.logit_softcap,
                              aligned=aligned)
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


class _TokenNLL(torch.autograd.Function):
    """logsumexp(logits) - logits[target] over the last dim; backward
    writes (softmax - onehot) g into one tensor (the autograd of the two
    ops holds five of the logits' size at its peak: the exp, its
    product, the gather's scattered zeros and their sum), the same values
    as that autograd's."""

    @staticmethod
    def forward(ctx, logits, targets):
        lse = torch.logsumexp(logits, dim=-1)
        idx = targets.long()[..., None]
        ctx.save_for_backward(logits, lse, idx)
        return lse - torch.gather(logits, -1, idx)[..., 0]

    @staticmethod
    def backward(ctx, g):
        logits, lse, idx = ctx.saved_tensors
        grad = (logits - lse[..., None]).exp_().mul_(g[..., None])
        grad.scatter_add_(-1, idx, -g[..., None])
        return grad, None


def token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-token NLL (..., V) f32 logits, (...) targets -> (...)."""
    return _TokenNLL.apply(logits, targets)


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
