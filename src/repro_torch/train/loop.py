"""Training step and loop on one device: the masked LM loss (plus the MoE
auxiliary loss), autograd over the parameter tree, microbatch gradient
accumulation, and the hand-written AdamW.

Parameters stay in ``cfg.param_dtype`` (f32 masters); the forward casts
each weight to ``cfg.dtype`` where it is used, as the JAX package does,
and ``cfg.remat == "full"`` recomputes each layer in the backward pass.
The sharded step of the JAX package (``make_sharded_train_step``) comes
with the port's distributed layer.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         init_opt_state)


def lm_loss(params, batch, cfg: ModelConfig, *, aux_weight: float = 0.01):
    """batch = (tokens, targets, mask[, embeddings]).  Returns (mean NLL
    over the mask + ``aux_weight`` x aux, {"loss": the NLL, "aux",
    "tokens": the mask's sum}).  The NLL is logsumexp(logits) minus the
    target's logit, read by a gather (the reference contracts a one-hot
    over the vocab, equal on finite logits without the (B, S, V) f32
    one-hot)."""
    tokens, targets, mask = batch[:3]
    kw = {"embeddings": batch[3]} if len(batch) > 3 else {}
    logits, _, aux = api.get_model(cfg).forward(params, tokens, cfg,
                                                return_aux=True, **kw)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = lse - tgt
    mask = mask.float()
    denom = torch.clamp_min(mask.sum(), 1.0)
    loss = torch.sum(nll * mask) / denom
    return loss + aux_weight * aux, {"loss": loss, "aux": aux,
                                     "tokens": denom}


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


def make_train_step(cfg: ModelConfig, oc: AdamWConfig, *,
                    microbatches: int = 1,
                    grad_transform: Optional[Callable] = None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics); the step writes the new params and moments into the ones
    it is given (``adamw_update``).

    ``microbatches`` > 1 splits the batch along dim 0 and accumulates f32
    grads from zeros, in order, then divides by the count; the loss and
    metrics are the microbatches' means.  ``grad_transform`` maps the
    grads between accumulation and the optimizer."""

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


def to_batch(batch, device) -> tuple:
    """A loader's numpy batch as tensors on ``device``."""
    return tuple(torch.as_tensor(b).to(device) for b in batch)


def train_loop(params, cfg: ModelConfig, oc: AdamWConfig, data_iter, *,
               n_steps: int, microbatches: int = 1, log_every: int = 20,
               checkpointer=None, ckpt_every: int = 0, monitor=None,
               log_fn=print):
    """Train ``n_steps`` from ``params`` (updated in place) on batches of
    ``data_iter``; returns (params, opt_state).  Every ``ckpt_every``
    steps ``checkpointer`` saves {"params", "opt", "step"}."""
    step_fn = make_train_step(cfg, oc, microbatches=microbatches)
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
            checkpointer.save({"params": params, "opt": opt_state,
                               "step": opt_state["step"]}, step=i + 1)
    return params, opt_state
