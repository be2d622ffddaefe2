"""Mixture-of-Experts FFN.

Dispatch is the sort-by-expert / capacity scheme of the JAX package:
tokens are routed top-k, sorted by expert id (stable, so a token's place
within its expert is its order ``t * k + j``), packed into an (E, C, d)
buffer (C = capacity; picks past it drop), run through batched expert
products, and combined back with the router weights.  A token's output
therefore depends on every token in the call: the callers feed padding
and idle rows exactly as the JAX engine does.

The experts are dense batched products (``torch.matmul``), as the JAX
package computes them as einsums outside any Pallas kernel.  Quantized
expert stacks are dequantized to f32 and cast to the activation dtype at
every call.

Under a mesh (``par``) the layer is the JAX package's ``shard_map``
branch written out: tokens split over ``par.batch_axes_for(B)`` and
routed within each shard (the router replicated), the experts' ff
sharded over ``model`` under ``tp`` with one ``psum`` over ``model``
after the down product, ``aux`` averaged over every axis, and the body
under ``torch.utils.checkpoint`` when it carries grads (the reference's
``jax.checkpoint``: the (E, C, d) buffers are recomputed in backward).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import (ParallelContext, axes_of,
                                              gather_leaf, shard_of)


def init_moe(cfg: ModelConfig, gen: torch.Generator, dtype, device) -> dict:
    """Router (d, E) and expert stacks gate/up (E, d, f), down (E, f, d),
    with the JAX package's distributions, from the seeded ``gen``."""
    m = cfg.moe
    d, f, E = cfg.d_model, m.expert_d_ff, m.n_experts

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=device).to(
            dtype) * scale

    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    return {
        "router": {"w": normal((d, E), s_in)},
        "experts": {"gate": normal((E, d, f), s_in),
                    "up": normal((E, d, f), s_in),
                    "down": normal((E, f, d), s_out)},
    }


def route(logits: torch.Tensor, m: MoEConfig):
    """logits: (T, E) -> (weights (T, k) f32, ids (T, k) int64, aux_loss).

    f32 softmax, top-k with ties broken toward the lower expert id (as
    ``jax.lax.top_k``; a stable descending sort, since ``torch.topk``
    promises no order among equal values), weights renormalized, and the
    switch load-balancing loss."""
    probs = torch.softmax(logits.float(), dim=-1)
    weights, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = weights[:, :m.top_k], ids[:, :m.top_k]
    weights = weights / torch.clamp_min(weights.sum(-1, keepdim=True), 1e-9)
    E = probs.shape[-1]
    density = F.one_hot(ids[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(density * probs.mean(dim=0))
    return weights, ids, aux


def capacity(T: int, m: MoEConfig) -> int:
    """Slots per expert for a call of T tokens."""
    return max(8, int(math.ceil(T * m.top_k / m.n_experts
                                * m.capacity_factor)))


def dispatch_slots(ids: torch.Tensor, m: MoEConfig):
    """Each pick's buffer slot.  ids: (T, k) -> (token_slot (T * k,) in
    pick order, the drop slot E * C for a pick past its expert's
    capacity; C)."""
    T, k = ids.shape
    E = m.n_experts
    C = capacity(T, m)
    flat = ids.reshape(T * k)
    order = torch.argsort(flat, stable=True)        # picks sorted by expert
    sorted_ids = flat[order]
    # per-expert counts (bincount's, as a scatter: the same on every
    # device, ``meta`` included, where bincount's shape is data-dependent)
    counts = torch.zeros(E, dtype=flat.dtype, device=flat.device)
    counts.index_add_(0, flat, torch.ones_like(flat))
    starts = torch.cumsum(counts, 0) - counts        # exclusive per expert
    pos = torch.arange(T * k, device=ids.device) - starts[sorted_ids]
    slot = torch.where(pos < C, sorted_ids * C + pos,
                       torch.full_like(pos, E * C))
    token_slot = torch.empty_like(slot)
    token_slot[order] = slot
    return token_slot, C


def dispatch_compute_combine(x: torch.Tensor, weights: torch.Tensor,
                             ids: torch.Tensor, experts: dict,
                             m: MoEConfig, axis_model=None,
                             mesh=None) -> torch.Tensor:
    """x: (T, d); experts gate/up (E, d, f), down (E, f, d) in x's dtype.
    Returns (T, d) in x's dtype: SiLU(gate) * up then down per expert
    over its (C, d) buffer, and each token's bf16 weighted sum over its k
    picks (a dropped pick adds zero).  ``axis_model``: the experts hold
    this rank's ff block, and the down products are summed over that
    mesh axis before the combine."""
    T, d = x.shape
    E, k = m.n_experts, m.top_k
    token_slot, C = dispatch_slots(ids, m)
    # slot -> source token row (T = a zero row for unfilled slots)
    slot_src = torch.full((E * C + 1,), T, dtype=torch.long, device=x.device)
    slot_src[token_slot] = torch.arange(T * k, device=x.device) // k
    x_pad = torch.cat([x, x.new_zeros((1, d))])
    xe = x_pad[slot_src[:E * C]].reshape(E, C, d)
    h = F.silu(torch.matmul(xe, experts["gate"])) * torch.matmul(
        xe, experts["up"])
    ye = torch.matmul(h, experts["down"])
    if axis_model is not None:
        ye = coll.psum(ye, axis_model, mesh)  # TP reduce over d_ff shards
    ye_pad = torch.cat([ye.reshape(E * C, d), ye.new_zeros((1, d))])
    contrib = ye_pad[token_slot].reshape(T, k, d)
    return torch.sum(contrib * weights.reshape(T, k, 1).to(contrib.dtype),
                     dim=1)


def expert_weights(experts: dict, dtype) -> dict:
    """The expert stacks in the activation dtype: fp stacks cast, quantized
    ones dequantized to f32 and then cast (the JAX package's rounding
    points)."""
    from repro_torch.quant.qlinear import dequantize_leaf, is_quantized

    return {name: (dequantize_leaf(w) if is_quantized(w) else w).to(dtype)
            for name, w in experts.items()}


def _local_moe(x, router_w, experts: dict, m: MoEConfig, axis_model,
               mesh):
    """The per-shard body: route this rank's tokens (B, S, d) and run
    them through its experts.  Returns (y, the shard's aux)."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    logits = torch.matmul(xf, router_w.to(xf.dtype))
    weights, ids, aux = route(logits, m)
    y = dispatch_compute_combine(xf, weights, ids, experts, m, axis_model,
                                 mesh)
    return y.reshape(B, S, d), aux


def moe_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig,
            par: ParallelContext = None, *, row_axes=None):
    """x: (B, S, d) -> (y (B, S, d), aux_loss scalar); the B * S tokens
    route and share the experts' capacity as one call.

    Under a mesh the parameters are global (the same on every rank; under
    tensor parallelism the experts may be the rank's ``model`` block of
    their ff dim, as stored) and ``x`` holds this rank's rows of a batch
    split over the mesh axes ``row_axes`` (None: the whole batch, the
    same on every rank; the sequence-parallel decode), ``y`` likewise.  The tokens are regrouped
    over the reference's shards, ``par.batch_axes_for`` of the global
    batch, when those are not ``row_axes``; each shard routes its own
    tokens, so the capacity and the drops are the JAX package's."""
    m = cfg.moe
    if par is None or par.mesh is None:
        return _local_moe(x, p["router"]["w"],
                          expert_weights(p["experts"], x.dtype), m, None,
                          None)
    mesh = par.mesh
    token_ax = par.batch_axes_for(x.shape[0] * par.size(row_axes))
    regroup = axes_of(token_ax) != axes_of(row_axes)
    if regroup:
        x = shard_of(gather_leaf(x, (row_axes,), par), (token_ax,), par)
    tp = par.tp and "model" in par.axes
    specs = {"gate": (None, None, "model"), "up": (None, None, "model"),
             "down": (None, "model", None)}
    f, n_model = cfg.moe.expert_d_ff, par.n_model

    def ff_block(name, w):
        # the tensor-parallel layout reads the stored ff block; a global
        # stack is cut to it
        if n_model > 1 and w.shape[-2 if name == "down" else -1] \
                * n_model == f:
            return w
        return shard_of(w, specs[name], par)

    experts = {name: ff_block(name, w) if tp else w
               for name, w in expert_weights(p["experts"], x.dtype).items()}
    args = (x, p["router"]["w"], experts, m, "model" if tp else None, mesh)
    if torch.is_grad_enabled() and (x.requires_grad or any(
            w.requires_grad for w in experts.values())):
        y, aux = checkpoint(_local_moe, *args, use_reentrant=False)
    else:
        y, aux = _local_moe(*args)
    aux = coll.pmean(aux, par.axes, mesh)  # replicated, as the out_spec P()
    if regroup:
        y = shard_of(gather_leaf(y, (token_ax,), par), (row_axes,), par)
    return y, aux
