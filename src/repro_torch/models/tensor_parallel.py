"""Every family on its per-device layout: compute that stays on the
``model`` shard of each weight (Megatron-style tensor parallelism), rows
on their ``data`` (and ``pod``) shard.

What the JAX package's GSPMD arrives at from its sharding rules
(``distributed/sharding.py``: heads, kv_heads, mlp and vocab on
``model``; Mamba2's ``in_proj`` columns, ``conv``, ``A_log`` /
``dt_bias`` / ``D`` and ``out_proj`` rows on ``model``) is written out
here, one projection at a time, from the shape of the rank's block of
each weight.  This module holds the pieces every family calls and the
transformer family (dense GQA, MoE, ``patch_stub``); ``tp_mamba2`` runs
Mamba2 and the zamba2 hybrid and ``tp_whisper`` the encoder-decoder on
them (:func:`family` picks the module):

- a column-parallel projection (``wq``, ``wk``, ``wv``, ``gate``, ``up``,
  ``fc1``, ``in_proj``) gives the rank's columns, its bias block
  included; where they are a whole number of heads the rank attends over
  those heads, else each head goes to the rank of its first column,
  which fetches the rest point to point (:func:`take`,
  ``collectives.regroup``);
- a row-parallel projection (``wo``, ``down``, ``fc2``, ``out_proj``)
  takes the rank's columns of its input and its partial output is summed
  over ``model`` (``psum``), or reduce-scattered along the sequence when
  the residual is sequence-sharded (``shard_activations_seq``); a
  replicated bias (``fc2/b``) is added once, after the sum
  (:func:`row_parallel`);
- the embedding looks up the ids of the rank's vocab block and sums the
  rows over ``model``; the LM head gives the rank's vocab block of the
  logits, which the loss and the sampler reduce without gathering;
- a weight whose dim does not divide ``model`` is stored whole
  (``param_specs`` drops the axis) and computes whole.

Weights never move over ``model``: the caller reads each leaf through
``train.loop.local_view``, which gathers a leaf over its other axes (the
FSDP ``embed_fsdp`` dims over ``data``) and asserts that it issues no
gather over ``model``.  Activations move instead.

With ``shard_activations_seq`` the residual between layers, which remat
saves, is this rank's block of the sequence over ``model``: each
column-parallel input is all-gathered along the sequence first and each
row-parallel output reduce-scattered back, so a transformer layer's
forward issues two all-gathers and two reduce-scatters of (B, S, d).
Without it the residual is whole and a layer issues two ``psum``s.

Every collective's backward is its transpose (``collectives.py``), so
the grads are those of the sum of every rank's loss; ``train.loop``
divides by the ranks that share each row.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import ParallelContext, shard_of
from repro_torch.models import layers as L


@dataclass(frozen=True)
class TPLayout:
    """A rank's place on the ``model`` axis, and the axes (a spec entry)
    its rows are split over."""
    par: ParallelContext
    rows: object = None

    @property
    def mesh(self):
        return self.par.mesh

    @property
    def m(self) -> int:
        return self.par.n_model

    @property
    def r(self) -> int:
        return C.axis_index("model", self.mesh) if self.m > 1 else 0

    @property
    def seq(self) -> bool:
        return self.par.shard_activations_seq and self.m > 1

    def whole_residual(self) -> "TPLayout":
        """This layout with the residual whole (for a sequence that does
        not split over ``model``, as Whisper's 1,500 frames on 16)."""
        return TPLayout(replace(self.par, shard_activations_seq=False),
                        self.rows)


FAMILIES = ("transformer", "mamba2", "hybrid", "encdec")


def applies(cfg: ModelConfig, par: Optional[ParallelContext]) -> bool:
    """Whether a program of ``cfg`` under ``par`` runs on this layout:
    every family (:data:`FAMILIES`) under a mesh with a ``model`` axis and
    tensor parallelism on."""
    return (cfg.family in FAMILIES and par is not None
            and par.mesh is not None and par.tp and "model" in par.axes)


def family(cfg: ModelConfig):
    """The module that runs ``cfg``'s family on this layout, with
    ``forward``, ``prefill``, ``decode_step`` and ``init_cache``: this
    one (the transformer family), ``tp_mamba2`` or ``tp_whisper``."""
    import sys

    if cfg.family in ("mamba2", "hybrid"):
        from repro_torch.models import tp_mamba2
        return tp_mamba2
    if cfg.family == "encdec":
        from repro_torch.models import tp_whisper
        return tp_whisper
    return sys.modules[__name__]


# ---------------------------------------------------------------------------
# Blocks of weights and activations
# ---------------------------------------------------------------------------


def in_features(p: dict) -> int:
    """K of a linear layer's (K, N) weight: fp, or Q4 / Q8 codes (K, ...)."""
    w = p["w"]
    return (w["codes"] if isinstance(w, dict) else w).shape[-2]


def blocks(n: int, m: int) -> list:
    """[a, b) of each rank's block of a dim of ``n`` split ``m`` ways."""
    return [(r * n // m, (r + 1) * n // m) for r in range(m)]


def _sharded(n_local: int, n: int, tp: TPLayout) -> bool:
    """Whether a dim of global size ``n`` is this rank's 1/m block."""
    if n_local == n:
        return False
    if n_local * tp.m != n:
        raise ValueError(f"a block of {n_local} of a dim of {n} on a model "
                         f"axis of {tp.m}")
    return True


def _q_plan(cfg: ModelConfig, m: int):
    """(have, own): per rank of ``model``, the columns [a, b) it holds of
    the q projection's output and those of the heads it computes: the
    heads whose first column it holds (all of its own where its columns
    are whole heads; a head split between ranks goes to the rank of its
    first column, and a rank whose columns start no head computes none).
    Where the projection is stored whole (its columns do not divide
    ``model``) every rank holds and computes every head."""
    hd = cfg.resolved_head_dim()
    H = cfg.n_heads
    if m == 1 or (H * hd) % m:
        return [(0, H * hd)] * m, [(0, H * hd)] * m
    n = H * hd // m
    have = [(r * n, (r + 1) * n) for r in range(m)]
    own = [(-(-r * n // hd) * hd, -(-(r + 1) * n // hd) * hd)
           for r in range(m)]
    return have, own


def kv_heads_read(cfg: ModelConfig, m: int, r: int):
    """The kv heads [lo, hi) rank r of ``model`` reads (GQA: q head h reads
    kv head h // G), which a prefill on this layout keeps in its cache;
    (0, 0) for a rank that computes no head."""
    _, own = _q_plan(cfg, m)
    hd = cfg.resolved_head_dim()
    G = cfg.n_heads // cfg.n_kv_heads
    h0, h1 = own[r][0] // hd, own[r][1] // hd
    return (h0 // G, (h1 - 1) // G + 1) if h1 > h0 else (0, 0)


def _all_heads(y, H: int, hd: int, tp: TPLayout):
    """Every head of a column-parallel projection's output, gathered over
    ``model`` where the rank holds a block."""
    if _sharded(y.shape[-1], H * hd, tp):
        y = C.all_gather(y, "model", tp.mesh, dim=y.dim() - 1, tiled=True)
    return y.view(*y.shape[:-1], H, hd)


def _cut(y, ranges, dim: int = -1):
    """Indices ``ranges`` (a range (a, b) or a tuple of ranges) of dim
    ``dim`` of y, concatenated in that order."""
    dim = dim % y.dim()
    parts = [y.narrow(dim, a, b - a) for a, b in C._ranges(ranges) if b > a]
    if len(parts) == 1:
        return parts[0]
    if not parts:
        shape = list(y.shape)
        shape[dim] = 0
        return y.new_empty(shape)
    return torch.cat(parts, dim=dim)


def take(y, n: int, want: list, tp: TPLayout, dim: int = -1):
    """Indices ``want[r]`` (a range (a, b) or a tuple of ranges, see
    ``collectives.regroup``) of dim ``dim`` of y on this rank, where y
    holds the rank's block of a dim of global size ``n`` (the others'
    pieces fetched point to point) or the whole dim (a slice)."""
    dim = dim % y.dim()
    if _sharded(y.shape[dim], n, tp):
        have = blocks(n, tp.m)
        if [C._ranges(w) for w in want] == [C._ranges(h) for h in have]:
            return y
        return C.regroup(y, have, want, "model", tp.mesh, dim=dim)
    if C._ranges(want[tp.r]) == ((0, n),):
        return y
    return _cut(y, want[tp.r], dim)


def _take_heads(y, H: int, hd: int, want: list, tp: TPLayout):
    """Columns ``want[r]`` (whole heads) of a column-parallel output y
    (B, S, n) on this rank: from its own columns, the others' fetched
    point to point where the rank holds a block (``collectives.regroup``);
    a slice where y is whole.  Returns (B, S, h, hd)."""
    B, S, _ = y.shape
    a, b = want[tp.r]
    return take(y, H * hd, want, tp).view(B, S, (b - a) // hd, hd)


def _reduce(y, sharded: bool, tp: TPLayout):
    """A row-parallel output to the residual's layout: summed over
    ``model`` (``psum``), or, sequence-sharded, reduce-scattered along the
    sequence; a whole weight's output is complete, and only cut to the
    rank's sequence block."""
    if tp.seq:
        if sharded:
            return C.psum_scatter(y, "model", tp.mesh, dim=1)
        return shard_of(y, (None, "model"), tp.par)
    return C.psum(y, "model", tp.mesh) if sharded else y


def _whole_seq(x, tp: TPLayout):
    """The residual's whole sequence (all-gathered along it under
    ``shard_activations_seq``)."""
    if tp.seq:
        return C.all_gather(x, "model", tp.mesh, dim=1, tiled=True)
    return x


# ---------------------------------------------------------------------------
# Layer pieces
# ---------------------------------------------------------------------------


def _group(q, q0: int, k, v, lo: int, G: int):
    """k, v for the rank's q heads [q0, q0 + h) in the (Hkv, G) grouping
    the attention takes: contiguous whole groups as they are, one kv head
    for heads within one group, else each q head's own kv head."""
    h = q.shape[2]
    if (q0 % G == 0 and h % G == 0) or q0 // G == (q0 + h - 1) // G:
        return k, v
    idx = torch.tensor([(q0 + i) // G - lo for i in range(h)],
                       device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def row_parallel(p: dict, a, n: int, tp: TPLayout, *,
                 sharded: Optional[bool] = None):
    """A row-parallel projection: the rank's block of the rows of ``p``'s
    weight (of ``n`` in all; or the whole weight) applied to the matching
    columns of a, reduced to the residual's layout (:func:`_reduce`), and
    the bias, which the rules replicate, added once after the sum.
    ``sharded``: whether the weight is a block, if the caller knows."""
    if sharded is None:
        sharded = _sharded(in_features(p), n, tp)
    y = _reduce(L.linear({"w": p["w"]}, a), sharded, tp)
    return y + p["b"].to(y.dtype) if "b" in p else y


def kv_heads(p: dict, x, cfg: ModelConfig, tp: TPLayout):
    """(k, v) (B, T, hi - lo, hd) of the kv heads [lo, hi) this rank reads
    (:func:`kv_heads_read`), projected from x (B, T, d) whole: the
    rank's columns of ``wk`` / ``wv``, bias blocks included, the rest
    fetched point to point."""
    hd = cfg.resolved_head_dim()
    kv_cols = [(a * hd, b * hd) for a, b in
               (kv_heads_read(cfg, tp.m, r) for r in range(tp.m))]
    return tuple(_take_heads(L.linear(p[w], x), cfg.n_kv_heads, hd, kv_cols,
                             tp) for w in ("wk", "wv"))


def attention(p: dict, h, cfg: ModelConfig, tp: TPLayout, **kw):
    """:func:`_attention`'s output reduced to the residual's layout, the
    ``wo`` bias (replicated) added once after the sum: (y, (k, v))."""
    y, sharded, kv = _attention(p, h, cfg, tp, **kw)
    y = _reduce(y, sharded, tp)
    return (y + p["wo"]["b"].to(y.dtype) if "b" in p["wo"] else y), kv


def _attention(p: dict, h, cfg: ModelConfig, tp: TPLayout, *, positions,
               window: int, aligned: bool, causal: bool = True, cross=None):
    """Self-attention of whole rows h (B, S, d) over the rank's heads
    (causal unless ``causal`` is False), or with ``cross`` = (k, v) of the
    kv heads the rank reads (:func:`kv_heads`, over an encoder's frames)
    cross attention, with no rope and no mask.  Returns (the row-parallel
    ``wo`` output before the sum and the bias, whether it is a partial
    sum, (k, v) of the kv heads the rank read, (B, S, h, hd) with rope).

    Where the rank's block of a projection is whole heads it attends over
    its own; else over the heads whose first column it holds
    (:func:`_q_plan`), each one's columns fetched point to point from
    the ranks that hold them, and the kv heads those read likewise.  The
    output's columns then go to the ranks whose block of ``wo`` takes
    them.  Only activations move."""
    hd = cfg.resolved_head_dim()
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    G = Hq // Hkv
    have, own = _q_plan(cfg, tp.m)
    sharded = _sharded(in_features(p["wo"]), Hq * hd, tp)
    assert sharded == (have[0] != (0, Hq * hd)), "wo's block vs the plan"
    q = _take_heads(L.linear(p["wq"], h), Hq, hd, own, tp)
    if cross is None:
        k, v = kv_heads(p, h, cfg, tp)
        kv_pos = positions
        if cfg.rope_theta:
            q = L.rope(q, positions, cfg.rope_theta)
            k = L.rope(k, positions, cfg.rope_theta)
    else:
        k, v = cross
        B, T = k.shape[:2]
        kv_pos = torch.arange(T, device=h.device)[None].expand(B, T)
    B, S = h.shape[:2]
    if q.shape[2]:
        kk, vv = _group(q, own[tp.r][0] // hd, k, v,
                        kv_heads_read(cfg, tp.m, tp.r)[0], G)
        o = L.chunked_attention(q, kk, vv, q_positions=positions,
                                kv_positions=kv_pos,
                                causal=causal and cross is None,
                                window=window, softcap=cfg.logit_softcap,
                                aligned=aligned).reshape(B, S, -1)
    else:  # a rank that starts no head
        o = h.new_empty((B, S, 0))
    if own != have:
        o = C.regroup(o, own, have, "model", tp.mesh, dim=2)
    return L.linear({"w": p["wo"]["w"]}, o), sharded, (k, v)


def ffn(p: dict, h, cfg: ModelConfig, tp: TPLayout):
    """SwiGLU over the rank's block of d_ff, reduced to the residual's
    layout."""
    a = F.silu(L.linear(p["gate"], h)) * L.linear(p["up"], h)
    return row_parallel(p["down"], a, cfg.d_ff, tp)


def embed(p: dict, tokens, cfg: ModelConfig, dtype, tp: TPLayout, *,
          scatter: bool):
    """Rows of the rank's vocab block of the table, the other ids zero,
    summed over ``model`` (``scatter``: reduce-scattered along the
    sequence instead).  A whole table looks up every id."""
    table = p["table"]
    V = cfg.vocab_size
    if not _sharded(table.shape[0], V, tp):
        x = L.embed(p, tokens, dtype)
        return shard_of(x, (None, "model"), tp.par) if scatter else x
    n = table.shape[0]
    local = tokens.long() - tp.r * n
    ok = (local >= 0) & (local < n)
    x = table.to(dtype)[local.clamp(0, n - 1)] * ok[..., None].to(dtype)
    if scatter:
        return C.psum_scatter(x, "model", tp.mesh, dim=1)
    return C.psum(x, "model", tp.mesh)


def _layer(lp, x, cfg, tp, positions, window, aligned, store):
    """One layer over the residual x (whole, or the rank's sequence block
    under ``shard_activations_seq``).  Returns (x, the (k, v) the rank
    read (:func:`kv_heads_read`) when ``store``, aux)."""
    h = _whole_seq(L.rmsnorm(lp["attn_norm"], x, cfg.norm_eps), tp)
    y, sharded, kv = _attention(lp["attn"], h, cfg, tp, positions=positions,
                                window=window, aligned=aligned)
    x = x + _reduce(y, sharded, tp)  # (no layer of the family has a wo bias)
    h = _whole_seq(L.rmsnorm(lp["ffn_norm"], x, cfg.norm_eps), tp)
    if "moe" in lp:
        from repro_torch.models.moe import moe_ffn

        y, aux = moe_ffn(lp["moe"], h, cfg, tp.par, row_axes=tp.rows)
        y = _reduce(y, False, tp)  # the MoE sums its experts' blocks itself
    else:
        y, aux = ffn(lp["ffn"], h, cfg, tp), None
    return x + y, kv if store else None, aux


def _train_layer(lp, x, cfg, tp, positions, window):
    x, _, aux = _layer(lp, x, cfg, tp, positions, window, True, False)
    return x, aux


def trunk(params, tokens, cfg: ModelConfig, tp: TPLayout, *,
          cache: Optional[dict] = None, embeddings=None):
    """The layers and the final norm over this rank's rows.  Returns (x,
    aux): x (B, S, d) whole (gathered along the sequence at the end
    under ``shard_activations_seq``); aux the layers' summed MoE loss.
    ``cache`` ({"k", "v"} of (L, B, S, hi - lo, hd)): each layer writes
    the (k, v) of the kv heads [lo, hi) the rank read
    (:func:`kv_heads_read`) into it, in place, as it runs.  Under ``cfg.remat == "full"`` with grads each layer runs
    under ``torch.utils.checkpoint`` (its collectives again in the
    recompute, as under the JAX package's remat)."""
    from repro_torch.models.transformer import layer_windows

    dtype = getattr(torch, cfg.dtype)
    B, S = tokens.shape
    if embeddings is not None:
        x = embed(params["embedding"], tokens, cfg, dtype, tp, scatter=False)
        pre = L.linear(params["patch_proj"], embeddings.to(dtype))
        x = torch.cat([pre, x[:, embeddings.shape[1]:]], dim=1)
        if tp.seq:
            x = shard_of(x, (None, "model"), tp.par)
    else:
        x = embed(params["embedding"], tokens, cfg, dtype, tp,
                  scatter=tp.seq)
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S)
    remat = cfg.remat == "full" and x.requires_grad and cache is None
    aux = None
    for i, (lp, w) in enumerate(zip(params["layers"], layer_windows(cfg))):
        if remat:
            x, a = checkpoint(_train_layer, lp, x, cfg, tp, positions, w,
                              use_reentrant=False)
        else:
            x, kv, a = _layer(lp, x, cfg, tp, positions, w, True,
                              cache is not None)
            if cache is not None:
                for name, t in zip(("k", "v"), kv):
                    cache[name][i] = t.to(cache[name].dtype)
        if a is not None:
            aux = a if aux is None else aux + a
    x = _whole_seq(L.rmsnorm(params["final_norm"], x, cfg.norm_eps), tp)
    aux = torch.zeros((), device=x.device) if aux is None else aux
    return x, aux


def forward(params, tokens, cfg: ModelConfig, tp: TPLayout, *,
            logit_positions=None, cache: Optional[dict] = None,
            embeddings=None):
    """Returns (logits, aux): the rank's vocab block of the f32 logits,
    (B, S, V / m) or at ``logit_positions`` (B, V / m) (the whole vocab
    where the table does not divide ``model``).  ``cache``: see
    :func:`trunk`."""
    from repro_torch.models.transformer import _head

    x, aux = trunk(params, tokens, cfg, tp, cache=cache,
                   embeddings=embeddings)
    if logit_positions is not None:
        x = x[torch.arange(x.shape[0], device=x.device),
              logit_positions.long()]
    return L.lm_logits(_head(params, cfg), x, cfg.logit_softcap), aux


class _VocabNLL(torch.autograd.Function):
    """logsumexp(logits) - logits[target] over a vocab split on
    ``model``: the max over ``model`` (``pmax``), the sum of exponentials
    and the target's logit (``psum``) forward; backward (softmax - onehot)
    g in one tensor, g summed over ``model`` (the transpose of the
    sums)."""

    @staticmethod
    def forward(ctx, logits, targets, offset, mesh):
        n = logits.shape[-1]
        mx = C.pmax(logits.amax(dim=-1), "model", mesh)
        se = C.psum(torch.exp(logits - mx[..., None]).sum(dim=-1), "model",
                    mesh)
        lse = mx + torch.log(se)
        local = targets.long() - offset
        ok = (local >= 0) & (local < n)
        idx = local.clamp(0, n - 1)[..., None]
        tgt = torch.gather(logits, -1, idx)[..., 0] * ok
        ctx.save_for_backward(logits, lse, idx, ok)
        ctx.mesh = mesh
        return lse - C.psum(tgt, "model", mesh)

    @staticmethod
    def backward(ctx, g):
        logits, lse, idx, ok = ctx.saved_tensors
        g = C.psum(g, "model", ctx.mesh)
        grad = (logits - lse[..., None]).exp_().mul_(g[..., None])
        grad.scatter_add_(-1, idx, -(g * ok)[..., None])
        return grad, None, None, None


def token_nll(logits, targets, cfg: ModelConfig, tp: TPLayout):
    """Per-token NLL, logsumexp(logits) - logits[target], from the rank's
    vocab block of the logits (:class:`_VocabNLL`), as the JAX package
    keeps both (B, S, V) tensors vocab-sharded; ``layers.token_nll`` on a
    whole vocab."""
    n = logits.shape[-1]
    if not _sharded(n, cfg.vocab_size, tp):
        return L.token_nll(logits, targets)
    return _VocabNLL.apply(logits, targets, tp.r * n, tp.mesh)


# ---------------------------------------------------------------------------
# Serving: prefill and the sequence-parallel decode step
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, tp: TPLayout, batch: int, max_len: int,
               dtype=None, *, device) -> dict:
    """Zeroed rank's part of a prefill's dense rows: {"k", "v"} (L,
    batch, max_len, hi - lo, hd) of the kv heads [lo, hi) it reads
    (:func:`kv_heads_read`)."""
    lo, hi = kv_heads_read(cfg, tp.m, tp.r)
    shape = (cfg.n_layers, batch, max_len, hi - lo, cfg.resolved_head_dim())
    dtype = dtype or getattr(torch, cfg.dtype)
    return {n: torch.zeros(shape, dtype=dtype, device=device)
            for n in ("k", "v")}


def prefill(params, tokens, cfg: ModelConfig, tp: TPLayout, *, lengths,
            cache: dict, embeddings=None):
    """Prompt forward over this rank's rows, writing each layer's (k, v)
    of the kv heads it read into ``cache`` ({"k", "v"} of (L, B, S, hi -
    lo, hd), heads [lo, hi) of :func:`kv_heads_read`) in place.  Returns
    the rank's vocab block of the (B, V) logits at each row's last
    position."""
    logits, _ = forward(params, tokens, cfg, tp, logit_positions=lengths - 1,
                        cache=cache, embeddings=embeddings)
    return logits


def decode_layer(lp, x, cfg: ModelConfig, tp: TPLayout, *, cache_k, cache_v,
                 cache_len, window: int):
    """One layer of a decode step over this rank's rows x (B, 1, d) and
    its block of the layer's cache, split along the sequence over
    ``tp.par.kv_seq_axis``: the rank projects q, k, v for its heads and
    all-gathers those (B, 1, H, hd) over ``model``, runs the
    sequence-parallel attention over its cache block
    (``serving.seq_parallel``), and takes its heads' columns of the output
    for the row-parallel ``wo``."""
    from repro_torch.serving.seq_parallel import _seq_shard_attention

    hd = cfg.resolved_head_dim()
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    p = lp["attn"]
    h = L.rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
    q = _all_heads(L.linear(p["wq"], h), Hq, hd, tp)
    k = _all_heads(L.linear(p["wk"], h), Hkv, hd, tp)
    v = _all_heads(L.linear(p["wv"], h), Hkv, hd, tp)
    if cfg.rope_theta:
        positions = (cache_len - 1)[:, None]
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
    axis = tp.par.kv_seq_axis
    ring = cache_k.shape[1] * C.axis_size(axis, tp.mesh) \
        if cfg.ring_cache else 0
    o = _seq_shard_attention(q, k, v, cache_k, cache_v, cache_len, window,
                             axis=axis, mesh=tp.mesh,
                             softcap=cfg.logit_softcap, ring_size=ring)
    o = o.reshape(x.shape[0], 1, Hq * hd)
    n = in_features(p["wo"])
    sharded = _sharded(n, Hq * hd, tp)
    if sharded:  # the columns of the rank's block of wo
        o = o.narrow(-1, tp.r * n, n)
    x = x + row_parallel(p["wo"], o, Hq * hd, tp, sharded=sharded)
    h = L.rmsnorm(lp["ffn_norm"], x, cfg.norm_eps)
    if "moe" in lp:
        from repro_torch.models.moe import moe_ffn

        y, _ = moe_ffn(lp["moe"], h, cfg, tp.par, row_axes=tp.rows)
        return x + y
    return x + ffn(lp["ffn"], h, cfg, tp)


def decode_step(params, tokens, cache: dict, cache_len, cfg: ModelConfig,
                tp: TPLayout):
    """One decode step over this rank's rows: tokens (B, 1), cache_len
    (B,) and the rank's blocks of the dense cache {"k", "v"} (L, B,
    S / n, Hkv, hd) split over ``tp.par.kv_seq_axis`` (written in place).
    Returns the rank's vocab block of the (B, V) f32 logits."""
    from repro_torch.models.transformer import _head, layer_windows, \
        pool_layer

    if tp.par.kv_seq_axis is None:
        raise ValueError("the tensor-parallel decode step takes a cache "
                         "split along the sequence (par.kv_seq_axis)")
    dtype = getattr(torch, cfg.dtype)
    x = embed(params["embedding"], tokens, cfg, dtype, tp, scatter=False)
    for i, (lp, w) in enumerate(zip(params["layers"], layer_windows(cfg))):
        x = decode_layer(lp, x, cfg, tp, cache_k=pool_layer(cache["k"], i),
                         cache_v=pool_layer(cache["v"], i),
                         cache_len=cache_len, window=w)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.lm_logits(_head(params, cfg), x[:, 0], cfg.logit_softcap)


def sample(logits, seed: int, sc, cfg: ModelConfig, tp: TPLayout):
    """Tokens of this rank's rows from its vocab block of the logits
    (``sampler.distributed_sample``'s shard math, without gathering
    them); a whole vocab samples whole, the same on every ``model``
    rank."""
    from repro_torch.serving import sampler as SM

    n = logits.shape[-1]
    if not _sharded(n, cfg.vocab_size, tp):
        return SM.distributed_sample(logits, seed, sc, None)
    if sc.greedy:
        return SM._local_greedy(logits, "model", tp.mesh, n)
    return SM._local_gumbel_max(logits, seed, sc.temperature, "model",
                                tp.mesh, n)
