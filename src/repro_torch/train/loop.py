"""Training step and loop: the masked LM loss (plus the MoE auxiliary
loss), autograd over the parameter tree, microbatch gradient
accumulation, the hand-written AdamW, and the sharded step.

Parameters stay in ``cfg.param_dtype`` (f32 masters); the forward casts
each weight to ``cfg.dtype`` where it is used, as the JAX package does,
and ``cfg.remat == "full"`` recomputes each layer in the backward pass.

The sharded step (``par`` with a mesh) keeps each leaf and its AdamW
moments as this rank's block of ``param_specs(par)`` in the JAX
package's layout (nested dicts, stacked layers: ``shard_params``), so a
rank stores what a device of the JAX layout stores.  Each rank takes
its rows of the global batch (``par.spec("batch")``), and the model
reads the blocks through a view that gathers a leaf where the model
uses it (``gather_leaf``; under remat inside each layer's recompute);
the gathers' backward reduce-scatters the grads.  Under tensor
parallelism every family computes on its ``model`` blocks
(``models.tensor_parallel`` and its family modules, read through
:func:`local_view`, which gathers a leaf over every axis but ``model``),
with the residual sequence-sharded under ``shard_activations_seq``;
without it (``par.tp`` False) the model reads every leaf gathered
(:func:`gathered_view`).
"""
from __future__ import annotations

import math
import time
from collections.abc import Mapping, Sequence
from typing import Callable, Optional

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import (ParallelContext, axes_of,
                                              gather_leaf, param_specs,
                                              shard_of, stack_layers)
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         init_opt_state)


def _sharded(par) -> bool:
    return par is not None and par.mesh is not None


def lm_loss(params, batch, cfg: ModelConfig,
            par: Optional[ParallelContext] = None, *,
            aux_weight: float = 0.01):
    """batch = (tokens, targets, mask[, embeddings]).  Returns (mean NLL
    over the mask + ``aux_weight`` x aux, {"loss": the NLL, "aux",
    "tokens": the mask's sum}).  The NLL is logsumexp(logits) minus the
    target's logit, read by a gather (``layers.token_nll``; the reference
    contracts a one-hot over the vocab, equal on finite logits without
    the (B, S, V) f32 one-hot).

    Under a mesh the batch is this rank's rows of ``par.spec("batch")``
    and the mask's sum is taken over every rank's rows; the first value
    is this rank's share of the objective (its NLL over the global
    denominator, plus the aux term over the number of batch shards), so
    that the sum over ranks, divided by the ranks that share each row, is
    the global loss.  The metrics are global."""
    from repro_torch.models import tensor_parallel as TP

    tokens, targets, mask = batch[:3]
    kw = {"embeddings": batch[3]} if len(batch) > 3 else {}
    if _sharded(par) and TP.applies(cfg, par):
        # this rank's vocab block of the logits, reduced over "model"
        tp = TP.TPLayout(par, rows=par.spec("batch")[0])
        logits, aux = TP.family(cfg).forward(params, tokens, cfg, tp, **kw)
        nll = TP.token_nll(logits.float(), targets, cfg, tp)
    else:
        if _sharded(par) and cfg.moe:
            kw["par"] = par
        logits, _, aux = api.get_model(cfg).forward(params, tokens, cfg,
                                                    return_aux=True, **kw)
        nll = L.token_nll(logits.float(), targets)
    mask = mask.float()
    if not _sharded(par):
        denom = torch.clamp_min(mask.sum(), 1.0)
        loss = torch.sum(nll * mask) / denom
        return loss + aux_weight * aux, {"loss": loss, "aux": aux,
                                         "tokens": denom}
    rows = par.spec("batch")[0]
    denom = torch.clamp_min(C.psum(mask.sum(), rows, par.mesh), 1.0)
    part = torch.sum(nll * mask) / denom
    loss = C.psum(part.detach(), rows, par.mesh)
    return part + aux_weight * aux / par.size(rows), {
        "loss": loss, "aux": aux.detach(), "tokens": denom}


def value_and_grad(params, batch, cfg: ModelConfig):
    """((total loss, metrics), grads congruent with ``params``), every
    value detached.  A leaf the loss does not reach gets a zero grad."""
    leaves, spec = T.flatten(params)
    ps = [p.detach().requires_grad_(True) for p in leaves]
    loss, metrics = lm_loss(T.unflatten(spec, ps), batch, cfg)
    gs = torch.autograd.grad(loss, ps, allow_unused=True)
    gs = [torch.zeros_like(p) if g is None else g for p, g in zip(ps, gs)]
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            T.unflatten(spec, gs))


# ---------------------------------------------------------------------------
# The sharded layout
# ---------------------------------------------------------------------------


def _is_layer_stack(key: str) -> bool:
    return key == "layers" or key.endswith("_layers")


def _gather(block, spec, par, layer, keep=()):
    if layer is None:
        return gather_leaf(block, spec, par, keep=keep)
    if spec[0] is None:
        return gather_leaf(block[layer], spec[1:], par, keep=keep)
    # the layer dim itself is sharded (the JAX rules shard whisper's
    # "enc_layers" / "dec_layers" stacks, which they do not see as stacked)
    return gather_leaf(block, spec, par, keep=keep)[layer]


class _Layers(Sequence):
    def __init__(self, blocks, specs, par, keep):
        self._b, self._s, self._par, self._keep = blocks, specs, par, keep
        self._n = T.flatten(blocks)[0][0].shape[0]

    def __len__(self):
        return self._n

    def __getitem__(self, i):
        if not 0 <= i < self._n:
            raise IndexError(i)
        return _View(self._b, self._s, self._par, layer=i, keep=self._keep)


class _View(Mapping):
    """The port's parameter tree over a JAX-layout tree of blocks: a top-
    level layer stack reads as a list of per-layer views, whose leaves
    are gathered each time the model reads them (under remat, again in
    the backward's recompute); a leaf outside the layers is gathered once
    per view (the tied embedding serves the lookup and the LM head).  A
    quantized leaf ({"codes", "scales"[, "codebook"]}) reads as a dict of
    its gathered parts.  ``keep``: axes not gathered over (each leaf then
    reads as the rank's block along them)."""

    def __init__(self, blocks, specs, par, layer=None, memo=None, keep=()):
        self._b, self._s, self._par, self._layer = blocks, specs, par, layer
        self._memo, self._keep = memo, keep

    def __getitem__(self, k):
        b, s = self._b[k], self._s[k]
        if isinstance(b, dict) and "codes" in b:  # a quantized leaf, whole
            parts = {n: self._leaf(b[n], s[n]) for n in b}
            return _align_parts(parts, b, s, self._par, self._layer,
                                self._keep)
        if isinstance(b, dict):
            if self._layer is None and _is_layer_stack(k):
                return _Layers(b, s, self._par, self._keep)
            return _View(b, s, self._par, self._layer, self._memo,
                         self._keep)
        return self._leaf(b, s)

    def _leaf(self, b, s):
        if self._memo is None:
            return _gather(b, s, self._par, self._layer, self._keep)
        if id(b) not in self._memo:
            self._memo[id(b)] = _gather(b, s, self._par, self._layer,
                                        self._keep)
        return self._memo[id(b)]

    def __contains__(self, k):
        return k in self._b

    def __iter__(self):
        return iter(self._b)

    def __len__(self):
        return len(self._b)


def _align_parts(parts, blocks, specs, par, layer, keep):
    """A quantized leaf read as the rank's blocks along ``keep``: a part
    stored whole where its codes are split (its dim did not divide, e.g.
    Q8 scales of K / 32 rows) is cut to the same block.  Where it cannot
    be cut (a tile-Q4 leaf whose column block is no whole number of
    16-column scale groups, zamba2-1.2b's ``in_proj`` on 16: 524 columns
    a rank), the leaf is kept whole: its codes are gathered along those
    axes, the one weight that moves over them, as ``param_specs`` keeps
    a dim that does not divide."""
    if not keep:
        return parts
    cspec = specs["codes"][1:] if layer is not None and \
        specs["codes"][0] is None else specs["codes"]
    cuts = {}
    for name, t in parts.items():
        sspec = specs[name][1:] if layer is not None and \
            specs[name][0] is None else specs[name]
        for d, entry in enumerate(cspec):
            kept = tuple(a for a in axes_of(entry) if a in keep)
            if kept and d < t.dim() and name != "codebook" and \
                    not set(kept) & set(axes_of(sspec[d] if d < len(sspec)
                                                else None)):
                if t.shape[d] % par.size(kept):
                    parts["codes"] = C.all_gather(parts["codes"], kept,
                                                  par.mesh, dim=d,
                                                  tiled=True)
                    return parts
                cuts[name] = (d, kept)
    for name, (d, kept) in cuts.items():
        parts[name] = shard_of(parts[name], (None,) * d + (kept,),
                               par).contiguous()
    return parts


def gathered_view(blocks, specs, par: ParallelContext):
    """The model's view of a sharded tree (see :class:`_View`)."""
    return _View(blocks, specs, par, memo={})


def local_view(blocks, specs, par: ParallelContext):
    """The tensor-parallel view of a sharded tree: each leaf gathered over
    every axis but ``model`` (the FSDP ``embed_fsdp`` dims over ``data``),
    so it reads as the rank's ``model`` block of the leaf, or the whole
    leaf where its spec does not name ``model``.  ``gather_leaf`` asserts
    that no weight is gathered over ``model``; the one exception is a Q4
    leaf whose block does not tile (:func:`_align_parts`)."""
    return _View(blocks, specs, par, memo={}, keep=("model",))


# the stacked layer lists of every family, which the dry-run's cells also
# pass to ``param_specs`` (the rules alone see only "layers" as stacked and
# would split Whisper's layer dim over "model")
LAYER_STACKS = ("layers", "enc_layers", "dec_layers")


def shard_params(params, par: ParallelContext):
    """(blocks, specs): the port's global tree (identical on every rank)
    as this rank's blocks of ``param_specs(par)`` in the JAX layout
    (nested dicts, stacked layers, each of :data:`LAYER_STACKS` seen as
    stacked), built leaf by leaf so no stacked copy of the whole tree is
    made."""
    abstract = stack_layers(T.map_with_path(lambda _, t: t.to("meta"),
                                            params))
    specs = param_specs(abstract, par, stacked_prefixes=LAYER_STACKS)
    out: dict = {}
    for path, parts, stacked in T.stacked_leaves(params):
        *keys, last = path.split("/")
        node, snode = out, specs
        for k in keys:
            node = node.setdefault(k, {})
            snode = snode[k]
        spec = snode[last]
        if stacked and spec[0] is None:
            block = torch.stack([shard_of(p, spec[1:], par) for p in parts])
        elif stacked:
            block = shard_of(torch.stack(parts), spec, par).clone()
        else:
            block = shard_of(parts[0], spec, par).clone()
        node[last] = block.detach()
    return out, specs


def state_specs(specs) -> dict:
    """Specs of the train state {"params", "opt", "step"}."""
    return {"params": specs, "opt": {"m": specs, "v": specs, "step": ()},
            "step": ()}


def _leaf_axes(spec, par) -> tuple:
    """The mesh axes a leaf is sharded on, in the mesh's order."""
    used = {a for entry in spec for a in axes_of(entry)}
    return tuple(a for a in par.axes if a in used)


def sharded_global_norm(grads, specs, par: ParallelContext):
    """The global norm of a tree of blocks: each leaf's squares summed over
    the ranks it is sharded across, a replicated leaf counted once."""
    sums: dict = {}
    for path, g in _leaves(grads):
        axes = _leaf_axes(_at(specs, path), par)
        sq = torch.sum(torch.square(g.float()))
        sums[axes] = sq if axes not in sums else sums[axes] + sq
    total = sum(C.psum(v, axes, par.mesh) if axes else v
                for axes, v in sums.items())
    return torch.sqrt(total)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def model_view(blocks, specs, cfg: ModelConfig, par: ParallelContext):
    """The view a sharded program of ``cfg`` reads its weights through:
    :func:`local_view` where the tensor-parallel layout applies
    (``models.tensor_parallel.applies``: every family under a ``model``
    axis with ``par.tp``), else :func:`gathered_view`."""
    from repro_torch.models import tensor_parallel as TP

    if TP.applies(cfg, par):
        return local_view(blocks, specs, par)
    return gathered_view(blocks, specs, par)


def _sharded_value_and_grad(blocks, specs, batch, cfg, par):
    leaves, tspec = T.flatten(blocks)
    ps = [p.detach().requires_grad_(True) for p in leaves]
    view = model_view(T.unflatten(tspec, ps), specs, cfg, par)
    loss, metrics = lm_loss(view, batch, cfg, par)
    gs = torch.autograd.grad(loss, ps, allow_unused=True)
    gs = [torch.zeros_like(p) if g is None else g for p, g in zip(ps, gs)]
    return metrics, T.unflatten(tspec, gs)


def _finish_grads(grads, specs, par):
    """Sum each block's grad over the axes it is replicated on (the
    gathers' backward summed the others; a block kept on ``model`` by the
    tensor-parallel layout has its whole grad already) and divide by the
    ranks that computed each batch row (the axes outside
    ``par.spec("batch")``: under tensor parallelism every ``model`` rank
    computes the same loss, so the sum over ranks counts it m times)."""
    rows = axes_of(par.spec("batch")[0])
    dup = math.prod(s for a, s in par.shape.items() if a not in rows)

    def one(path, g):
        used = _leaf_axes(_at(specs, path), par)
        rest = tuple(a for a in par.axes if a not in used)
        g = C.psum(g, rest, par.mesh) if rest else g
        return g / dup if dup > 1 else g

    return T.map_with_path(one, grads)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


def make_train_step(cfg: ModelConfig, oc: AdamWConfig,
                    par: Optional[ParallelContext] = None, *,
                    microbatches: int = 1,
                    grad_transform: Optional[Callable] = None,
                    specs=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics); the step writes the new params and moments into the ones
    it is given (``adamw_update``).

    ``microbatches`` > 1 splits the batch along dim 0 and accumulates f32
    grads from zeros, in order, then divides by the count; the loss and
    metrics are the microbatches' means.  ``grad_transform`` maps the
    grads between accumulation and the optimizer.

    Under a mesh, or given ``specs``, ``params`` and the moments are this
    rank's blocks in the JAX layout (:func:`shard_params`; ``specs``
    default to ``param_specs`` of the config's tree; with no mesh the
    blocks are the whole leaves), ``batch`` is the *global* batch (the
    same on every rank; each microbatch's rows are split over
    ``par.spec("batch")``), and ``grad_transform`` gets the blocks'
    finished grads."""
    if _sharded(par) or specs is not None:
        par = par or ParallelContext()
        return _make_sharded_step(cfg, oc, par, microbatches, grad_transform,
                                  specs)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            (loss, metrics), grads = value_and_grad(params, batch, cfg)
        else:
            def split(x, i):
                n = x.shape[0] // microbatches
                return x[i * n:(i + 1) * n]

            grads = T.map_with_path(
                lambda _, p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params)
            loss, ms = 0.0, []
            for i in range(microbatches):
                (l, m), g = value_and_grad(
                    params, tuple(split(b, i) for b in batch), cfg)
                grads = T.map_with_path(lambda _, a, b: a + b, grads, g)
                loss = loss + l
                ms.append(m)
            grads = T.map_with_path(lambda _, g: g / microbatches, grads)
            loss = loss / microbatches
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        if grad_transform is not None:
            grads = grad_transform(grads)
        params, opt_state, om = adamw_update(params, grads, opt_state, oc)
        return params, opt_state, {**metrics, **om, "total_loss": loss}

    return train_step


def _make_sharded_step(cfg, oc, par, microbatches, grad_transform, specs):
    if specs is None:
        specs = param_specs(stack_layers(api.abstract_params(cfg)), par,
                            stacked_prefixes=LAYER_STACKS)
    rows = par.spec("batch")[0]

    def train_step(blocks, opt_state, batch):
        B = batch[0].shape[0]
        if B % microbatches or (B // microbatches) % par.size(rows):
            raise ValueError(f"batch {B} in {microbatches} microbatches does "
                             f"not split over {rows} ({par.size(rows)} ways)")
        n = B // microbatches
        grads, ms = None, []
        for i in range(microbatches):
            mb = tuple(shard_of(b[i * n:(i + 1) * n], (rows,), par)
                       for b in batch)
            m, g = _sharded_value_and_grad(blocks, specs, mb, cfg, par)
            grads = g if grads is None else T.map_with_path(
                lambda _, a, b: a + b, grads, g)
            ms.append(m)
        grads = _finish_grads(grads, specs, par)
        if microbatches > 1:
            grads = T.map_with_path(lambda _, g: g / microbatches, grads)
        metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        if grad_transform is not None:
            grads = grad_transform(grads)
        gnorm = sharded_global_norm(grads, specs, par)
        blocks, opt_state, om = adamw_update(blocks, grads, opt_state, oc,
                                             grad_norm=gnorm)
        total = metrics["loss"] + 0.01 * metrics["aux"]
        return blocks, opt_state, {**metrics, **om, "total_loss": total}

    return train_step


def make_sharded_train_step(cfg: ModelConfig, oc: AdamWConfig,
                            par: ParallelContext, abstract_params, *,
                            microbatches: int = 1,
                            grad_transform: Optional[Callable] = None):
    """The sharded step with the specs of ``abstract_params`` (a global
    tree in the JAX layout; ``meta`` tensors will do)."""
    return make_train_step(cfg, oc, par, microbatches=microbatches,
                           grad_transform=grad_transform,
                           specs=param_specs(abstract_params, par))


def to_batch(batch, device) -> tuple:
    """A loader's numpy batch as tensors on ``device``."""
    return tuple(torch.as_tensor(b).to(device) for b in batch)


def train_loop(params, cfg: ModelConfig, oc: AdamWConfig, data_iter, *,
               n_steps: int, par: Optional[ParallelContext] = None,
               microbatches: int = 1, log_every: int = 20,
               checkpointer=None, ckpt_every: int = 0, monitor=None,
               log_fn=print):
    """Train ``n_steps`` from ``params`` (updated in place) on batches of
    ``data_iter``; returns (params, opt_state).  Every ``ckpt_every``
    steps ``checkpointer`` saves {"params", "opt", "step"}.  Under a mesh
    ``params`` is the global tree (the same on every rank), sharded here;
    the returned params and moments are this rank's blocks, and the
    checkpoints hold the gathered global arrays, written by rank 0."""
    specs = None
    if _sharded(par):
        params, specs = shard_params(params, par)
    step_fn = make_train_step(cfg, oc, par, microbatches=microbatches,
                              specs=specs)
    opt_state = init_opt_state(params)
    device = T.flatten(params)[0][0].device
    t0 = time.time()
    for i in range(n_steps):
        batch = to_batch(next(data_iter), device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if monitor is not None:
            monitor.record_step(time.time() - t0)
            t0 = time.time()
        if log_every and (i % log_every == 0 or i == n_steps - 1):
            log_fn(f"step {i:5d} loss {float(metrics['loss']):.4f} "
                   f"lr {float(metrics['lr']):.2e} "
                   f"gnorm {float(metrics['grad_norm']):.2f}")
        if checkpointer is not None and ckpt_every and \
                (i + 1) % ckpt_every == 0:
            state = {"params": params, "opt": opt_state,
                     "step": opt_state["step"]}
            save_state(checkpointer, state, specs, par, step=i + 1)
    return params, opt_state


def save_state(checkpointer, state, specs, par, *, step: int) -> None:
    """Save {"params", "opt", "step"}: as it is on one device; under a
    mesh each leaf gathered to the host one at a time and written by rank
    0 alone (every rank takes part in the gathers)."""
    if not _sharded(par):
        checkpointer.save(state, step=step)
        return
    import torch.distributed as dist

    from repro_torch.distributed.sharding import gather_tree

    root = dist.get_rank() == 0
    host = gather_tree(state, state_specs(specs), par,
                       to="cpu" if root else "meta")
    if root:
        checkpointer.save(host, step=step)
    dist.barrier()
