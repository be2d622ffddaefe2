"""Token sampling: greedy, temperature, top-k and top-p (nucleus), and
sampling from vocab-sharded logits (``distributed_sample``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 1.0
    top_k: int = 0          # 0 = no top-k
    top_p: float = 1.0      # 1 = no nucleus
    greedy: bool = False


def _mask_top_k(logits, k):
    thresh = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits >= thresh, logits, float("-inf"))


def _mask_top_p(logits, p):
    # stable sort, so among tied logits lower token ids sort first
    order = torch.argsort(-logits, dim=-1, stable=True)
    sorted_logits = torch.gather(logits, -1, order)
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    # keep the smallest prefix with cumulative prob >= p (always the first);
    # mask by sorted *rank*, not by value: a value cutoff would keep every
    # token tied with the nucleus boundary and overshoot the target mass
    cutoff_idx = (cum < p).sum(dim=-1, keepdim=True)
    ranks = torch.argsort(order, dim=-1)
    return torch.where(ranks <= cutoff_idx, logits, float("-inf"))


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           sc: SamplerConfig) -> torch.Tensor:
    """logits: (B, V) f32 -> tokens (B,) int32.  Greedy takes the lowest
    index among tied maxima; otherwise a Gumbel-max categorical draw from
    ``generator`` (on the logits' device)."""
    if sc.greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    x = logits / max(sc.temperature, 1e-6)
    if sc.top_k:
        x = _mask_top_k(x, sc.top_k)
    if sc.top_p < 1.0:
        x = _mask_top_p(x, sc.top_p)
    # the Gumbel noise computed in place on the draw: one (B, V) buffer
    # where the out-of-place chain held two more at once (room for the
    # decode graph's logits buffer, which stays allocated through here)
    g = torch.rand(x.shape, generator=generator, device=x.device)
    g.clamp_(1e-20, 1.0).log_().neg_().log_().neg_()
    return torch.argmax(x + g, dim=-1).to(torch.int32)


def logprobs_of(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Per-token log-probabilities. (B, V), (B,) -> (B,)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(lp, -1, tokens.long()[:, None])[:, 0]


# ---------------------------------------------------------------------------
# Vocab-sharded sampling (beyond-paper: removes the paper's lm_head wall)
# ---------------------------------------------------------------------------

_INT32_MAX = 2 ** 31 - 1


def _merge_shard_winners(loc_max, loc_arg, axis, mesh):
    """Global argmax across shards with unsharded-``argmax`` tie
    semantics: among shards achieving the global max, the *lowest* global
    index wins (pmin over winner candidates; losers contribute
    INT32_MAX)."""
    from repro_torch.distributed import collectives as C

    glob_max = C.pmax(loc_max, axis, mesh)
    winner = torch.where(loc_max >= glob_max, loc_arg,
                         torch.full_like(loc_arg, _INT32_MAX))
    return C.pmin(winner, axis, mesh).to(torch.int32)


def _local_gumbel_max(logits_loc, seed: int, temperature: float, axis,
                      mesh, vocab_per_shard: int):
    """Per-shard iid Gumbel noise from a generator seeded by ``seed`` and
    the shard's index (the JAX package folds the shard into its key; the
    two packages' random streams differ, the distribution does not)."""
    from repro_torch.distributed import collectives as C

    shard = C.axis_index(axis, mesh)
    gen = None  # a meta tensor (the dry-run) draws nothing
    if logits_loc.device.type != "meta":
        gen = torch.Generator(device=logits_loc.device)
        gen.manual_seed(int(seed) * 1_000_003 + shard)
    u = torch.rand(logits_loc.shape, generator=gen,
                   device=logits_loc.device)
    g = -torch.log(-torch.log(u.clamp(1e-20, 1.0)))
    y = logits_loc / max(temperature, 1e-6) + g
    loc_max, loc_arg = y.amax(dim=-1), torch.argmax(y, dim=-1)
    return _merge_shard_winners(loc_max, loc_arg + shard * vocab_per_shard,
                                axis, mesh)


def _local_greedy(logits_loc, axis, mesh, vocab_per_shard: int):
    from repro_torch.distributed import collectives as C

    shard = C.axis_index(axis, mesh)
    loc_max = logits_loc.amax(dim=-1)
    loc_arg = torch.argmax(logits_loc, dim=-1)
    return _merge_shard_winners(loc_max, loc_arg + shard * vocab_per_shard,
                                axis, mesh)


def distributed_sample(logits: torch.Tensor, seed: int, sc: SamplerConfig,
                       par) -> torch.Tensor:
    """Sample from (B, V) logits sharded over the ``model`` axis without
    gathering them.  Greedy = distributed argmax; stochastic = distributed
    Gumbel-max (exact categorical sample, temperature folded in; top-k and
    top-p are not applied, as in the JAX package).

    ``logits`` are global (the same on every rank); each rank reads its
    rows of ``par.batch_axes_for(B)`` and its vocab block, and the tokens
    come back global.  Without a ``model`` axis, or when the vocab does
    not divide it (internvl2's 151655), :func:`sample` runs on the whole
    logits with a generator seeded by ``seed``."""
    from repro_torch.distributed.sharding import gather_leaf, shard_of

    if par is None or par.mesh is None or "model" not in par.axes or \
            logits.shape[-1] % par.n_model:
        gen = None
        if logits.device.type != "meta":
            gen = torch.Generator(device=logits.device)
            gen.manual_seed(int(seed))
        return sample(logits, gen, sc)
    vps = logits.shape[-1] // par.n_model
    batch_axes = par.batch_axes_for(logits.shape[0])
    lg = shard_of(logits, (batch_axes, "model"), par)
    if sc.greedy:
        tok = _local_greedy(lg, "model", par.mesh, vps)
    else:
        tok = _local_gumbel_max(lg, seed, sc.temperature, "model", par.mesh,
                                vps)
    return gather_leaf(tok, (batch_axes,), par)
