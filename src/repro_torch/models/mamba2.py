"""Mamba2 (SSD, state-space duality, arXiv:2405.21060) and the zamba2
hybrid (a Mamba2 backbone plus one *shared* attention + SwiGLU block
applied every ``hybrid_attn_every`` layers, arXiv:2411.15242), as plain
functions over parameter dicts of tensors.

Prefill runs the chunked SSD scan: quadratic attention-like work within
chunks of ``chunk_size`` tokens plus a linear scan of per-chunk states.
Decode is the O(1)-per-token recurrence
    h <- h e^{dt A} + dt x (x) B ;  y = C h + D x
with a rolling buffer of the conv's last W - 1 inputs.  Every rounding
point is the JAX package's: activations in ``cfg.dtype``, the decays,
states and the intra-chunk product's accumulation in f32.

Parameters are {"embedding", "layers": [per-layer dict, ...],
"final_norm"[, "lm_head"][, "shared_attn"]}; the layers run as a Python
loop (the JAX package scans stacked leaves; ``bridge`` splits them) and
the shared block, one set of weights, is applied after layer i when
``i % every == every - 1``.  The cache is dense rows, updated **in
place**: {"conv" (L, B, W - 1, conv_dim) in ``cfg.dtype``, "ssm" (L, B,
H, P, N) f32[, "attn_k", "attn_v" (n_apps, B, max_len, Hkv, D)]}, batch
on axis 1 of every leaf.  There is no paged layout: the recurrent state
is per row, not per token.

Under a mesh with a ``model`` axis the same layers run on each weight's
and cache leaf's ``model`` block: ``models.tp_mamba2`` (``mamba_layer``,
``mamba_decode_step``, ``forward``, ``prefill``, ``decode_step``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import param_generator, resolve_device
from repro_torch.models import layers as L

FAMILIES = ("mamba2", "hybrid")


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    H = s.n_heads(cfg.d_model)
    conv_dim = di + 2 * s.ngroups * s.d_state
    return s, di, H, conv_dim


def _n_attn_apps(cfg: ModelConfig) -> int:
    if cfg.family != "hybrid" or not cfg.hybrid_attn_every:
        return 0
    return cfg.n_layers // cfg.hybrid_attn_every


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None) -> dict:
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (CUDA unless asked otherwise), in ``cfg.param_dtype``.  The JAX
    package's distributions (``A_log`` 0, ``dt_bias`` -2, ``D`` 1, conv
    weights N(0, 1/W), linear weights N(0, 1/in), embeddings N(0, 0.02^2));
    not the same numbers."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"the port's mamba2 module serves the {FAMILIES} "
                         f"families, got {cfg.family!r}")
    dev = resolve_device(device)
    gen = param_generator(dev, seed)
    dtype = getattr(torch, cfg.param_dtype)
    s, di, H, conv_dim = _dims(cfg)
    d = cfg.d_model

    def dense(i: int, o: int, bias: bool = False) -> dict:
        w = torch.randn((i, o), generator=gen, device=dev) / math.sqrt(i)
        p = {"w": w.to(dtype)}
        if bias:
            p["b"] = torch.zeros((o,), dtype=dtype, device=dev)
        return p

    def norm(n: int = d) -> dict:
        return {"scale": torch.ones((n,), device=dev)}

    def full(value: float) -> torch.Tensor:
        return torch.full((H,), value, device=dev)

    d_in_proj = 2 * di + 2 * s.ngroups * s.d_state + H
    layers = []
    for _ in range(cfg.n_layers):
        conv_w = torch.randn((s.conv_width, conv_dim), generator=gen,
                             device=dev).to(dtype) * (
                                 1.0 / math.sqrt(s.conv_width))
        layers.append({
            "norm": norm(),
            "in_proj": dense(d, d_in_proj),
            "conv": {"w": conv_w,
                     "b": torch.zeros((conv_dim,), dtype=dtype, device=dev)},
            "A_log": full(0.0),       # A = -exp(A_log) = -1
            "dt_bias": full(-2.0),    # softplus(-2) ~ 0.13
            "D": full(1.0),
            "gated_norm": norm(di),
            "out_proj": dense(di, d),
        })

    def table() -> dict:
        t = torch.randn((cfg.vocab_size, d), generator=gen, device=dev)
        return {"table": (t * 0.02).to(dtype)}

    params = {"embedding": table(), "layers": layers, "final_norm": norm()}
    if not cfg.tie_embeddings:
        params["lm_head"] = table()
    if _n_attn_apps(cfg):
        hd = cfg.resolved_head_dim()
        params["shared_attn"] = {
            "attn_norm": norm(),
            "attn": {"wq": dense(d, cfg.n_heads * hd, cfg.qkv_bias),
                     "wk": dense(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
                     "wv": dense(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
                     "wo": dense(cfg.n_heads * hd, d)},
            "ffn_norm": norm(),
            "ffn": {"gate": dense(d, cfg.d_ff), "up": dense(d, cfg.d_ff),
                    "down": dense(cfg.d_ff, d)},
        }
    return params


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               device) -> dict:
    """Zeroed dense rows: the conv buffer and the f32 SSM state per layer,
    and the shared block's KV per application (hybrid)."""
    dtype = dtype or getattr(torch, cfg.dtype)
    s, di, H, conv_dim = _dims(cfg)
    cache = {
        "conv": torch.zeros((cfg.n_layers, batch, s.conv_width - 1,
                             conv_dim), dtype=dtype, device=device),
        "ssm": torch.zeros((cfg.n_layers, batch, H, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
    }
    n_apps = _n_attn_apps(cfg)
    if n_apps:
        shape = (n_apps, batch, max_len, cfg.n_kv_heads,
                 cfg.resolved_head_dim())
        cache["attn_k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["attn_v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


# ---------------------------------------------------------------------------
# One Mamba2 block
# ---------------------------------------------------------------------------


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` computes it (logaddexp(x, 0))."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of width W.  x: (B, S, C) -> (B, S, C)."""
    W, S = p["w"].shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    y = sum(xp[:, i:i + S] * p["w"][i].to(x.dtype) for i in range(W))
    return y + p["b"].to(x.dtype)


def _split_in_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    s, di, H, _ = _dims(cfg)
    gn = s.ngroups * s.d_state
    return torch.split(zxbcdt, [di, di + 2 * gn, H], dim=-1)


def _heads(t: torch.Tensor, H: int, dim: int) -> torch.Tensor:
    """Group axis ``dim`` of size G -> H heads: group g serves heads
    [g H/G, (g + 1) H/G) (the JAX package's broadcast for G = 1, its
    ``repeat`` otherwise)."""
    G = t.shape[dim]
    if G == 1:
        shape = list(t.shape)
        shape[dim] = H
        return t.expand(shape)
    return t.repeat_interleave(H // G, dim=dim)


def _ssd_chunked(x, dt, A, B_mat, C_mat, cfg: ModelConfig,
                 initial_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    x: (B, S, H, P); dt: (B, S, H) post-softplus; A: (H,) negative;
    B_mat, C_mat: (B, S, G, N).  Returns (y (B, S, H, P) in x.dtype, the
    final state (B, H, P, N) f32).  A tail shorter than a chunk is padded
    with dt = 0 (decay 1, no state update), so the final state is the
    state after the last real token."""
    Bb, S, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    Q = min(cfg.ssm.chunk_size, S)
    S_orig = S
    if S % Q:
        pad = Q - S % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_mat = F.pad(B_mat, (0, 0, 0, 0, 0, pad))
        C_mat = F.pad(C_mat, (0, 0, 0, 0, 0, pad))
        S += pad
    nc = S // Q
    f32 = torch.float32
    da = (dt * A[None, None]).to(f32)                  # (B, S, H), <= 0
    dtx = x * dt[..., None].to(x.dtype)                # (B, S, H, P)

    def chunk(t):  # (B, S, ...) -> (B, nc, Q, ...)
        return t.reshape(Bb, nc, Q, *t.shape[2:])

    cs = torch.cumsum(chunk(da), dim=2)                # (B, nc, Q, H)
    dtx_c, B_c, C_c = chunk(dtx), chunk(B_mat), chunk(C_mat)

    # intra-chunk: decay L[q, s] = exp(cs[q] - cs[s]) for s <= q; above the
    # diagonal exp overflows, so it is dropped by where, never by a product
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]  # (B, nc, Q, Q, H)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))
    Lmat = torch.where(causal[None, None, :, :, None], torch.exp(diff),
                       torch.zeros((), device=x.device))
    cb = torch.einsum("bcqgn,bcsgn->bcqsg", C_c.to(f32), B_c.to(f32))
    w = (_heads(cb, H, 4) * Lmat).to(x.dtype)
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", w.to(f32), dtx_c.to(f32))

    # per-chunk states: sum_s exp(cs_last - cs[s]) dtx[s] (x) B[s]
    last = cs[:, :, -1:, :]                            # (B, nc, 1, H)
    decay_state = torch.exp(last - cs)                 # (B, nc, Q, H)
    Bh = _heads(B_c, H, 3).to(f32)                     # (B, nc, Q, H, N)
    states = torch.einsum("bcqh,bcqhp,bcqhn->bchpn", decay_state,
                          dtx_c.to(f32), Bh)

    # inter-chunk recurrence, emitting the state entering each chunk
    chunk_decay = torch.exp(last[:, :, 0, :])          # (B, nc, H)
    h = (torch.zeros((Bb, H, P, N), dtype=f32, device=x.device)
         if initial_state is None else initial_state.to(f32))
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                # (B, nc, H, P, N)

    # inter-chunk output: C[q] . (h_prev exp(cs[q]))
    Ch = _heads(C_c, H, 3).to(f32)
    y_inter = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Ch, h_prev,
                           torch.exp(cs))
    y = (y_intra + y_inter).reshape(Bb, S, H, P).to(x.dtype)
    return y[:, :S_orig], h


def mamba_layer(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """Full-sequence Mamba2 block (prefill).  x: (B, S, d).  Returns
    (x + out, (conv_state (B, W - 1, conv_dim), ssm_state (B, H, P, N)
    f32)): the conv state is the last W - 1 raw conv inputs."""
    s, di, H, conv_dim = _dims(cfg)
    B, S, _ = x.shape
    hn = L.rmsnorm(p["norm"], x, cfg.norm_eps)
    z, xBC, dt = _split_in_proj(L.linear(p["in_proj"], hn), cfg)
    conv_state = xBC[:, S - (s.conv_width - 1):, :]
    xBC = F.silu(_causal_conv(p["conv"], xBC))
    gn = s.ngroups * s.d_state
    xs, B_mat, C_mat = torch.split(xBC, [di, gn, gn], dim=-1)
    xs = xs.reshape(B, S, H, s.head_dim)
    B_mat = B_mat.reshape(B, S, s.ngroups, s.d_state)
    C_mat = C_mat.reshape(B, S, s.ngroups, s.d_state)
    dt_a = _softplus(dt.float() + p["dt_bias"][None, None])
    A = -torch.exp(p["A_log"])
    y, h_final = _ssd_chunked(xs, dt_a, A, B_mat, C_mat, cfg)
    y = y + xs * p["D"][None, None, :, None].to(xs.dtype)
    y = y.reshape(B, S, di)
    y = L.rmsnorm(p["gated_norm"], y * F.silu(z), cfg.norm_eps)
    return x + L.linear(p["out_proj"], y), (conv_state, h_final)


def mamba_decode_step(p: dict, x: torch.Tensor, state, cfg: ModelConfig):
    """One-token recurrent step.  x: (B, 1, d); state = (conv (B, W - 1,
    conv_dim), ssm (B, H, P, N) f32).  Returns (x + out, (new conv, new
    ssm)), new tensors (the caller writes them into its cache)."""
    s, di, H, conv_dim = _dims(cfg)
    B = x.shape[0]
    conv_st, ssm_st = state
    hn = L.rmsnorm(p["norm"], x, cfg.norm_eps)
    z, xBC, dt = _split_in_proj(L.linear(p["in_proj"], hn), cfg)

    window = torch.cat([conv_st.to(xBC.dtype), xBC], dim=1)  # (B, W, C)
    w = p["conv"]["w"].to(xBC.dtype)
    conv_out = torch.einsum("bwc,wc->bc", window, w) + \
        p["conv"]["b"].to(xBC.dtype)
    xBC = F.silu(conv_out)[:, None, :]
    new_conv = window[:, 1:, :]

    gn = s.ngroups * s.d_state
    xs, B_mat, C_mat = torch.split(xBC, [di, gn, gn], dim=-1)
    xs = xs.reshape(B, H, s.head_dim)
    f32 = torch.float32
    Bh = _heads(B_mat.reshape(B, s.ngroups, s.d_state), H, 1).to(f32)
    Ch = _heads(C_mat.reshape(B, s.ngroups, s.d_state), H, 1).to(f32)

    dt_a = _softplus(dt[:, 0].float() + p["dt_bias"][None])  # (B, H)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt_a * A[None])
    dx = xs.to(f32) * dt_a[..., None]                  # (B, H, P)
    upd = dx[..., :, None] * Bh[:, :, None, :]         # (B, H, P, N)
    h = ssm_st.to(f32) * decay[:, :, None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", h, Ch)
    y = y + xs.to(f32) * p["D"][None, :, None]
    y = y.reshape(B, 1, di).to(x.dtype)
    y = L.rmsnorm(p["gated_norm"], y * F.silu(z), cfg.norm_eps)
    return x + L.linear(p["out_proj"], y), (new_conv.to(conv_st.dtype), h)


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------


def _shared_attn_apply(sp: dict, x, cfg: ModelConfig, *, positions,
                       cache=None, cache_len=None):
    h, kv = L.attention_block(
        sp["attn"], L.rmsnorm(sp["attn_norm"], x, cfg.norm_eps), cfg,
        positions=positions, window=0, cache=cache, cache_len=cache_len)
    x = x + h
    x = x + L.swiglu(sp["ffn"], L.rmsnorm(sp["ffn_norm"], x, cfg.norm_eps))
    return x, kv


def _is_app(cfg: ModelConfig, i: int) -> bool:
    """Whether the shared block follows layer ``i``."""
    every = cfg.hybrid_attn_every
    return bool(_n_attn_apps(cfg)) and i % every == every - 1


def _head(params, cfg):
    return params["embedding"] if cfg.tie_embeddings else params["lm_head"]


def _train_layer(lp, x, cfg):
    return mamba_layer(lp, x, cfg)[0]


def forward(params, tokens, cfg: ModelConfig, *,
            logit_positions: Optional[torch.Tensor] = None,
            return_kv: bool = False, return_aux: bool = False,
            embeddings: Optional[torch.Tensor] = None):
    """Full-sequence forward.  tokens: (B, S).  Returns (logits, (states,
    kvs)): logits (B, S, V) f32, or (B, V) at ``logit_positions`` (B,);
    with ``return_kv`` the per-layer (conv, ssm) final states and the
    shared block's rope'd (k, v) (B, S, Hkv, D) per application, else
    empty lists.  ``return_aux`` appends a zero auxiliary loss, as the
    JAX package returns.  With ``cfg.remat == "full"`` and activations
    that carry gradients (training), each Mamba2 layer runs under
    ``torch.utils.checkpoint``.  ``embeddings`` is taken and ignored, as
    the JAX package's ``forward`` takes it: the family has no modality
    frontend."""
    x = L.embed(params["embedding"], tokens, getattr(torch, cfg.dtype))
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S)
    states, kvs = [], []
    remat = cfg.remat == "full" and x.requires_grad and not return_kv
    for i, lp in enumerate(params["layers"]):
        if remat:
            x = checkpoint(_train_layer, lp, x, cfg, use_reentrant=False)
        else:
            x, st = mamba_layer(lp, x, cfg)
            if return_kv:
                states.append(st)
        if _is_app(cfg, i):
            x, kv = _shared_attn_apply(params["shared_attn"], x, cfg,
                                       positions=positions)
            if return_kv:
                kvs.append(kv)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if logit_positions is not None:
        x = x[torch.arange(B, device=x.device), logit_positions.long()]
    logits = L.lm_logits(_head(params, cfg), x, cfg.logit_softcap)
    if return_aux:
        return logits, (states, kvs), torch.zeros((), device=x.device)
    return logits, (states, kvs)


def prefill(params, tokens, cfg: ModelConfig, *, lengths, cache: dict,
            embeddings: Optional[torch.Tensor] = None):
    """Run prompts and write their states into dense cache rows of
    :func:`init_cache`, in place.  Returns the (B, V) f32 logits at each
    row's position ``lengths - 1``.

    The SSM consumes every input position, padding included, so right-
    padded prompts of unequal length leave pad tokens in a shorter row's
    state, as in the JAX package (whose scheduler pads every prompt to
    its ``prompt_len``); the shared block's KV of the first S slots is
    written whole and masked later by the rows' lengths.  ``embeddings``
    is ignored (see :func:`forward`)."""
    logits, (states, kvs) = forward(params, tokens, cfg,
                                    logit_positions=lengths - 1,
                                    return_kv=True)
    for i, (conv, ssm) in enumerate(states):
        cache["conv"][i] = conv.to(cache["conv"].dtype)
        cache["ssm"][i] = ssm
    S = tokens.shape[1]
    for app, (k, v) in enumerate(kvs):
        cache["attn_k"][app, :, :S] = k.to(cache["attn_k"].dtype)
        cache["attn_v"][app, :, :S] = v.to(cache["attn_v"].dtype)
    return logits


def decode_step(params, tokens, cache: dict, cache_len, cfg: ModelConfig,
                par=None, *, keep: Optional[torch.Tensor] = None):
    """One decode step.  tokens: (B, 1); cache: the dense rows of
    :func:`prefill`; cache_len: (B,) int32 length *after* this token.
    Writes the new conv/ssm states and the shared block's K/V (at slot
    ``cache_len - 1``) into the cache in place and returns the (B, V) f32
    next-token logits.

    ``keep``: (B,) bool rows whose conv/ssm states come out unchanged
    (the engine's done rows, which the JAX engine restores by ``where``
    after its step; their attention K/V write goes to the slot their
    ``cache_len`` names, ``max_len - 1`` for a done row).

    ``par`` with a ``kv_seq_axis``: the shared block attends over this
    rank's block of ``attn_k`` / ``attn_v`` (``seq_parallel.shard_cache``)
    through the sequence-parallel layer with window 0; the rows, the
    conv / ssm states and the logits are global, as in the JAX
    package."""
    seq_par = par is not None and par.kv_seq_axis is not None
    x = L.embed(params["embedding"], tokens, getattr(torch, cfg.dtype))
    positions = (cache_len - 1)[:, None]
    for i, lp in enumerate(params["layers"]):
        conv, ssm = cache["conv"][i], cache["ssm"][i]
        x, (new_conv, new_ssm) = mamba_decode_step(lp, x, (conv, ssm), cfg)
        if keep is not None:
            new_conv = torch.where(keep[:, None, None], conv, new_conv)
            new_ssm = torch.where(keep[:, None, None, None], ssm, new_ssm)
        conv.copy_(new_conv)
        ssm.copy_(new_ssm)
        if _is_app(cfg, i):
            app = i // cfg.hybrid_attn_every
            if seq_par:
                from repro_torch.serving.seq_parallel import \
                    seq_parallel_decode_layer
                x, _, _ = seq_parallel_decode_layer(
                    params["shared_attn"], x, cfg, par,
                    cache_k=cache["attn_k"][app],
                    cache_v=cache["attn_v"][app], cache_len=cache_len,
                    window=0)
                continue
            x, _ = _shared_attn_apply(
                params["shared_attn"], x, cfg, positions=positions,
                cache={"k": cache["attn_k"][app], "v": cache["attn_v"][app]},
                cache_len=cache_len)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.lm_logits(_head(params, cfg), x[:, 0], cfg.logit_softcap)
