"""Mamba2 and the zamba2 hybrid on the per-device layout
(``models.tensor_parallel``): each Mamba2 layer computes from the rank's
``model`` block of every weight and cache leaf that the sharding rules
split (``in_proj`` columns, ``conv``, ``A_log`` / ``dt_bias`` / ``D``
heads, ``out_proj`` rows; the ``conv`` and ``ssm`` cache leaves), the
counterpart of ``models.mamba2`` on one device.

A rank computes the heads whose first row of ``out_proj`` it holds (all
of them where ``out_proj`` is whole, as ``tensor_parallel._q_plan``
assigns q heads).  ``in_proj`` is one fused projection, ``[z | x | B | C
| dt]``, and its column block does not line up with that split, nor the
``conv`` block with the heads, so the activation's columns move to where
the next op's block needs them (``collectives.regroup``, point to
point), twice a layer:

- from the ``in_proj`` block to the rank's heads' z and dt and its
  ``conv`` block of [x | B | C];
- after the conv, to the rank's heads' x and every rank's B and C.

The gated RMSNorm spans all of ``d_inner``: its mean square is the
``psum`` of the ranks' sums of squares over their heads' channels.
``out_proj`` is row-parallel (``tensor_parallel.row_parallel``), after
the normed output has moved from the rank's heads to its block of rows.
Under ``shard_activations_seq`` the layer all-gathers its input along
the sequence (the conv and the chunked scan run along the whole
sequence) and reduce-scatters the output of ``out_proj``.

The cache is the rank's blocks: "conv" (L, B, W - 1, conv_dim / m, or
whole), "ssm" (L, B, H / m, P, N, or whole: a whole leaf ends each step
equal on every rank, the heads' states fetched from their ranks),
"attn_k" / "attn_v" (the hybrid's shared block: at prefill the kv heads
the rank read, at decode its block of the sequence over
``par.kv_seq_axis``).  The shared attention block runs through the
transformer's pieces (``tensor_parallel._layer``, ``decode_layer``).
"""
from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as C
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import tensor_parallel as TP
from repro_torch.models.tensor_parallel import TPLayout


@dataclass(frozen=True)
class _Plan:
    """Where a Mamba2 layer's dims live on ``model``: each rank's heads
    [h0, h1) (``own``), and whether ``conv``'s channels, ``out_proj``'s
    rows and the per-head vectors are split (``in_proj``'s columns are
    read off its output's width, ``tensor_parallel.take``)."""
    di: int
    H: int
    P: int
    gn: int
    conv_dim: int
    n_in: int
    conv_split: bool
    out_split: bool
    heads_split: bool
    own: tuple

    def in_want(self, m: int) -> list:
        """Per rank, the ``in_proj`` columns it takes: its heads' z, its
        ``conv`` block of [x | B | C] and its heads' dt."""
        cb = TP.blocks(self.conv_dim, m) if self.conv_split else \
            [(0, self.conv_dim)] * m
        di, P, dt0 = self.di, self.P, self.di + self.conv_dim
        return [((h0 * P, h1 * P), (di + c0, di + c1), (dt0 + h0, dt0 + h1))
                for (h0, h1), (c0, c1) in zip(self.own, cb)]

    def conv_want(self) -> list:
        """Per rank, the conv outputs it takes: its heads' x, then B and
        C whole."""
        return [((h0 * self.P, h1 * self.P), (self.di, self.di + 2 * self.gn))
                for h0, h1 in self.own]


def _plan(lp, cfg: ModelConfig, tp: TPLayout) -> _Plan:
    s, di, H, conv_dim = M._dims(cfg)
    gn = s.ngroups * s.d_state
    n_in = 2 * di + 2 * gn + H
    P = s.head_dim
    out_split = TP._sharded(TP.in_features(lp["out_proj"]), di, tp)
    if out_split:  # a head goes to the rank of its first row of out_proj
        n = di // tp.m
        own = tuple((-(-r * n // P), -(-(r + 1) * n // P))
                    for r in range(tp.m))
    else:
        own = ((0, H),) * tp.m
    heads_split = TP._sharded(lp["A_log"].shape[-1], H, tp)
    assert not heads_split or list(own) == TP.blocks(H, tp.m), \
        "the heads' vectors vs out_proj's rows"
    return _Plan(di, H, P, gn, conv_dim, n_in,
                 TP._sharded(lp["conv"]["w"].shape[-1], conv_dim, tp),
                 out_split, heads_split, own)


def _read(lp) -> dict:
    """A layer's leaves read once each into plain dicts (a sharded view
    gathers a leaf over its other axes at every read)."""
    return {k: _read(v) if isinstance(v, Mapping) else v
            for k, v in lp.items()}


def _vec(t, pl: _Plan, tp: TPLayout):
    """A per-head vector (``A_log``, ``dt_bias``, ``D``) at the rank's
    heads: its block, or cut from the whole vector."""
    if pl.heads_split:
        return t
    h0, h1 = pl.own[tp.r]
    return t[h0:h1]


def _split_in(lp, hn, pl: _Plan, tp: TPLayout):
    """z (rank's heads), xBC (rank's conv block, raw), dt (rank's heads)
    from the rank's ``in_proj`` block applied to hn."""
    h0, h1 = pl.own[tp.r]
    y = TP.take(L.linear(lp["in_proj"], hn), pl.n_in, pl.in_want(tp.m), tp)
    nz = (h1 - h0) * pl.P
    return torch.split(y, [nz, y.shape[-1] - nz - (h1 - h0), h1 - h0],
                       dim=-1)


def _x_bc(xbc, pl: _Plan, cfg: ModelConfig, tp: TPLayout):
    """The conv's output moved to the rank's heads' x and the whole B and
    C: (xs (..., h, P), B (..., G, N), C (..., G, N)), each for the heads
    [h0, h1) (B and C cut to those heads' groups where ngroups > 1)."""
    s = cfg.ssm
    h0, h1 = pl.own[tp.r]
    y = TP.take(xbc, pl.conv_dim, pl.conv_want(), tp)
    xs, B, Cm = torch.split(y, [(h1 - h0) * pl.P, pl.gn, pl.gn], dim=-1)
    lead = xs.shape[:-1]
    xs = xs.reshape(*lead, h1 - h0, pl.P)
    B = B.reshape(*lead, s.ngroups, s.d_state)
    Cm = Cm.reshape(*lead, s.ngroups, s.d_state)
    if s.ngroups > 1 and (h0, h1) != (0, pl.H):
        idx = torch.tensor([h * s.ngroups // pl.H for h in range(h0, h1)],
                           device=xs.device)
        B, Cm = B.index_select(-2, idx), Cm.index_select(-2, idx)
    return xs, B, Cm


def _gated_out(lp, y, z, pl: _Plan, cfg: ModelConfig, tp: TPLayout):
    """The gated RMSNorm over all of d_inner (the mean square a ``psum``
    of the ranks' sums of squares), then row-parallel ``out_proj``: the
    normed channels move from the rank's heads to its block of rows."""
    g = y * F.silu(z)
    if not pl.out_split:
        return TP.row_parallel(lp["out_proj"], L.rmsnorm(
            lp["gated_norm"], g, cfg.norm_eps), pl.di, tp)
    h0, h1 = pl.own[tp.r]
    gf = g.float()
    ss = C.psum((gf * gf).sum(dim=-1, keepdim=True), "model", tp.mesh)
    scale = lp["gated_norm"]["scale"][h0 * pl.P:h1 * pl.P].float()
    g = (gf * torch.rsqrt(ss / pl.di + cfg.norm_eps) * scale).to(g.dtype)
    own = [(a * pl.P, b * pl.P) for a, b in pl.own]
    rows = TP.blocks(pl.di, tp.m)
    if own != rows:
        g = C.regroup(g, own, rows, "model", tp.mesh, dim=-1)
    return TP.row_parallel(lp["out_proj"], g, pl.di, tp)


def _ssm_whole(h, pl: _Plan, cache_heads: int, tp: TPLayout):
    """The rank's heads' SSM states (B, h, P, N) as the cache leaf keeps
    them: as they are where the leaf is the rank's block of heads, else
    every head's, fetched from their ranks."""
    if cache_heads != pl.H or pl.own == ((0, pl.H),) * tp.m:
        return h
    return C.regroup(h, [(a, b) for a, b in pl.own], [(0, pl.H)] * tp.m,
                     "model", tp.mesh, dim=1)


def mamba_layer(lp, x, cfg: ModelConfig, tp: TPLayout, *,
                ssm_heads: int = 0):
    """The full-sequence Mamba2 block on this rank (``mamba2.mamba_layer``
    on its blocks).  x: the residual (B, S, d), whole or (under
    ``shard_activations_seq``) the rank's block of the sequence.  Returns
    (x + out, (conv state (B, W - 1, the rank's conv channels), ssm state
    (B, heads, P, N) f32: the rank's heads, or every head where
    ``ssm_heads`` is H))."""
    s = cfg.ssm
    lp = _read(lp)
    pl = _plan(lp, cfg, tp)
    hn = TP._whole_seq(L.rmsnorm(lp["norm"], x, cfg.norm_eps), tp)
    B, S, _ = hn.shape
    z, xbc, dt = _split_in(lp, hn, pl, tp)
    conv_state = xbc[:, S - (s.conv_width - 1):, :]
    xbc = F.silu(M._causal_conv(lp["conv"], xbc))
    xs, Bm, Cm = _x_bc(xbc, pl, cfg, tp)
    h0, h1 = pl.own[tp.r]
    if h1 > h0:
        dt_a = M._softplus(dt.float() + _vec(lp["dt_bias"], pl, tp)[None,
                                                                     None])
        A = -torch.exp(_vec(lp["A_log"], pl, tp))
        y, h_final = M._ssd_chunked(xs, dt_a, A, Bm, Cm, cfg)
        y = y + xs * _vec(lp["D"], pl, tp)[None, None, :, None].to(xs.dtype)
    else:  # a rank that starts no head
        y = xs
        h_final = xs.new_zeros((B, 0, pl.P, s.d_state), dtype=torch.float32)
    y = y.reshape(B, S, (h1 - h0) * pl.P)
    out = _gated_out(lp, y, z, pl, cfg, tp)
    return x + out, (conv_state, _ssm_whole(h_final, pl, ssm_heads, tp))


def mamba_decode_step(lp, x, state, cfg: ModelConfig, tp: TPLayout):
    """One-token recurrent step on this rank (``mamba2.mamba_decode_step``
    on its blocks).  x: (B, 1, d); state = (conv (B, W - 1, the rank's
    conv channels), ssm (B, heads, P, N) f32, the rank's heads or every
    head).  Returns (x + out, (new conv, new ssm)) in the cache's
    layout, new tensors."""
    s = cfg.ssm
    conv_st, ssm_st = state
    lp = _read(lp)
    pl = _plan(lp, cfg, tp)
    B = x.shape[0]
    hn = L.rmsnorm(lp["norm"], x, cfg.norm_eps)
    z, xbc, dt = _split_in(lp, hn, pl, tp)
    window = torch.cat([conv_st.to(xbc.dtype), xbc], dim=1)
    w = lp["conv"]["w"].to(xbc.dtype)
    conv_out = torch.einsum("bwc,wc->bc", window, w) + \
        lp["conv"]["b"].to(xbc.dtype)
    new_conv = window[:, 1:, :]
    xs, Bm, Cm = _x_bc(F.silu(conv_out)[:, None, :], pl, cfg, tp)
    h0, h1 = pl.own[tp.r]
    f32 = torch.float32
    xs = xs[:, 0]
    H_own = h1 - h0
    Bh = M._heads(Bm[:, 0], H_own, 1).to(f32)
    Ch = M._heads(Cm[:, 0], H_own, 1).to(f32)
    dt_a = M._softplus(dt[:, 0].float() + _vec(lp["dt_bias"], pl, tp)[None])
    A = -torch.exp(_vec(lp["A_log"], pl, tp))
    decay = torch.exp(dt_a * A[None])
    dx = xs.to(f32) * dt_a[..., None]
    st = ssm_st if ssm_st.shape[1] == H_own else ssm_st[:, h0:h1]
    h = st.to(f32) * decay[:, :, None, None] + dx[..., :, None] * \
        Bh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", h, Ch)
    y = y + xs.to(f32) * _vec(lp["D"], pl, tp)[None, :, None]
    y = y.reshape(B, 1, H_own * pl.P).to(x.dtype)
    out = _gated_out(lp, y, z, pl, cfg, tp)
    return x + out, (new_conv.to(conv_st.dtype),
                     _ssm_whole(h, pl, ssm_st.shape[1], tp))


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------


def _train_layer(lp, x, cfg, tp):
    return mamba_layer(lp, x, cfg, tp)[0]


def _train_shared(sp, x, cfg, tp, positions):
    return TP._layer(sp, x, cfg, tp, positions, 0, True, False)[0]


def forward(params, tokens, cfg: ModelConfig, tp: TPLayout, *,
            logit_positions=None, cache: Optional[dict] = None,
            embeddings=None):
    """Returns (logits, aux): the rank's vocab block of the f32 logits,
    (B, S, V / m) or at ``logit_positions`` (B, V / m) (the whole vocab
    where the table does not divide ``model``), and a zero auxiliary
    loss.  ``cache`` (:func:`init_cache`): each layer writes its states,
    and each application of the shared block the (k, v) of the kv heads
    the rank read, in place.  Under ``cfg.remat == "full"`` with grads
    each layer and each application of the shared block runs under
    ``torch.utils.checkpoint``.  ``embeddings`` is ignored, as in
    ``mamba2.forward``."""
    dtype = getattr(torch, cfg.dtype)
    B, S = tokens.shape
    x = TP.embed(params["embedding"], tokens, cfg, dtype, tp, scatter=tp.seq)
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S)
    remat = cfg.remat == "full" and x.requires_grad and cache is None
    for i, lp in enumerate(params["layers"]):
        if remat:
            x = checkpoint(_train_layer, lp, x, cfg, tp, use_reentrant=False)
        else:
            x, (conv, ssm) = mamba_layer(
                lp, x, cfg, tp,
                ssm_heads=0 if cache is None else cache["ssm"].shape[2])
            if cache is not None:
                cache["conv"][i] = conv.to(cache["conv"].dtype)
                cache["ssm"][i] = ssm
        if M._is_app(cfg, i):
            sp = params["shared_attn"]
            if remat:
                x = checkpoint(_train_shared, sp, x, cfg, tp, positions,
                               use_reentrant=False)
                continue
            x, kv, _ = TP._layer(sp, x, cfg, tp, positions, 0, True,
                                 cache is not None)
            if cache is not None:
                app = i // cfg.hybrid_attn_every
                for name, t in zip(("attn_k", "attn_v"), kv):
                    cache[name][app, :, :S] = t.to(cache[name].dtype)
    x = TP._whole_seq(L.rmsnorm(params["final_norm"], x, cfg.norm_eps), tp)
    if logit_positions is not None:
        x = x[torch.arange(B, device=x.device), logit_positions.long()]
    logits = L.lm_logits(M._head(params, cfg), x, cfg.logit_softcap)
    return logits, torch.zeros((), device=x.device)


def init_cache(cfg: ModelConfig, tp: TPLayout, batch: int, max_len: int,
               dtype=None, *, device) -> dict:
    """Zeroed rank's blocks of a prefill's dense rows: "conv" (L, B, W -
    1, conv_dim / m, or whole), "ssm" (L, B, H / m or H, P, N) f32 as
    ``configs.inputs.cache_specs`` splits them, and the hybrid's
    "attn_k" / "attn_v" (n_apps, B, max_len, hi - lo, hd) of the kv heads
    [lo, hi) the rank reads (``tensor_parallel.kv_heads_read``)."""
    dtype = dtype or getattr(torch, cfg.dtype)
    s, di, H, conv_dim = M._dims(cfg)
    m = tp.m
    cache = {
        "conv": torch.zeros((cfg.n_layers, batch, s.conv_width - 1,
                             conv_dim // m if conv_dim % m == 0
                             else conv_dim), dtype=dtype, device=device),
        "ssm": torch.zeros((cfg.n_layers, batch,
                            H // m if H % m == 0 else H, s.head_dim,
                            s.d_state), dtype=torch.float32, device=device),
    }
    n_apps = M._n_attn_apps(cfg)
    if n_apps:
        lo, hi = TP.kv_heads_read(cfg, m, tp.r)
        shape = (n_apps, batch, max_len, hi - lo, cfg.resolved_head_dim())
        cache["attn_k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["attn_v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def prefill(params, tokens, cfg: ModelConfig, tp: TPLayout, *, lengths,
            cache: dict, embeddings=None):
    """Prompt forward over this rank's rows, writing the rank's part of
    each layer's states (and of the shared block's KV) into ``cache``
    (:func:`init_cache`) in place.  Returns the rank's vocab block of the
    (B, V) logits at each row's position ``lengths - 1``."""
    logits, _ = forward(params, tokens, cfg, tp, logit_positions=lengths - 1,
                        cache=cache)
    return logits


def decode_cache(cache: dict, cfg: ModelConfig, tp: TPLayout, max_len: int,
                 length: int) -> dict:
    """The rank's prefill cache (:func:`init_cache`, ``length`` tokens
    written) as :func:`decode_step` takes it under ``tp`` (whose
    ``par.kv_seq_axis`` splits the attention cache): "conv" and "ssm" as
    they are; the hybrid's "attn_k" / "attn_v" with every kv head fetched
    from the ranks that read it (point to point over ``model``), cut to
    the rank's block of ``max_len`` slots along the sequence."""
    out = {"conv": cache["conv"], "ssm": cache["ssm"]}
    if "attn_k" not in cache:
        return out
    Hkv = cfg.n_kv_heads
    have, lo = [], 0
    for a, b in (TP.kv_heads_read(cfg, tp.m, r) for r in range(tp.m)):
        have.append((max(a, lo), max(b, lo)))  # each head from one rank
        lo = max(lo, b)
    axis = tp.par.kv_seq_axis
    n = C.axis_size(axis, tp.mesh)
    blk = max_len // n
    s0 = C.axis_index(axis, tp.mesh) * blk
    s1 = min(length, s0 + blk)
    mine = TP.kv_heads_read(cfg, tp.m, tp.r)[0]
    for name in ("attn_k", "attn_v"):
        t = cache[name][:, :, :length]
        a, b = have[tp.r]
        t = t.narrow(3, a - mine, b - a)
        if tp.m > 1:
            t = C.regroup(t, have, [(0, Hkv)] * tp.m, "model", tp.mesh, dim=3)
        dec = t.new_zeros(t.shape[:2] + (blk,) + t.shape[3:])
        if s1 > s0:
            dec[:, :, :s1 - s0] = t[:, :, s0:s1]
        out[name] = dec
    return out


def decode_step(params, tokens, cache: dict, cache_len, cfg: ModelConfig,
                tp: TPLayout):
    """One decode step over this rank's rows: tokens (B, 1), cache_len
    (B,) and the rank's blocks of the dense cache ("conv", "ssm" as
    ``configs.inputs.cache_specs`` splits them; the hybrid's "attn_k" /
    "attn_v" split along the sequence over ``tp.par.kv_seq_axis``),
    written in place.  Returns the rank's vocab block of the (B, V) f32
    logits."""
    if M._n_attn_apps(cfg) and tp.par.kv_seq_axis is None:
        raise ValueError("the hybrid's tensor-parallel decode step takes an "
                         "attention cache split along the sequence "
                         "(par.kv_seq_axis)")
    x = TP.embed(params["embedding"], tokens, cfg, getattr(torch, cfg.dtype),
                 tp, scatter=False)
    for i, lp in enumerate(params["layers"]):
        conv, ssm = cache["conv"][i], cache["ssm"][i]
        x, (new_conv, new_ssm) = mamba_decode_step(lp, x, (conv, ssm), cfg,
                                                   tp)
        conv.copy_(new_conv)
        ssm.copy_(new_ssm)
        if M._is_app(cfg, i):
            app = i // cfg.hybrid_attn_every
            x = TP.decode_layer(params["shared_attn"], x, cfg, tp,
                                cache_k=cache["attn_k"][app],
                                cache_v=cache["attn_v"][app],
                                cache_len=cache_len, window=0)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.lm_logits(M._head(params, cfg), x[:, 0], cfg.logit_softcap)
