"""AdamW and LR schedules written out by hand, in the JAX package's order
of operations (``torch.optim.AdamW`` applies its decay to the parameter
before the Adam step; the reference adds it to the update).

The optimizer state is {"m", "v": f32 trees congruent with the params,
"step": int32 scalar}.  The decay mask leaves out every leaf whose last
key is a norm ``scale`` or ``bias``, or a Mamba2 ``A_log``, ``dt_bias``
or ``D``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import tree as T


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"  # "cosine" | "linear" | "constant"


def lr_at(step, oc: AdamWConfig) -> torch.Tensor:
    """The learning rate at ``step`` (int or int tensor), as an f32
    scalar tensor: linear warmup, then cosine or linear decay to 0 at
    ``total_steps``, or constant."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp_max(step / max(oc.warmup_steps, 1), 1.0)
    if oc.schedule == "constant":
        decay = 1.0
    else:
        t = torch.clamp((step - oc.warmup_steps)
                        / max(oc.total_steps - oc.warmup_steps, 1), 0.0, 1.0)
        decay = (0.5 * (1 + torch.cos(math.pi * t))
                 if oc.schedule == "cosine" else 1.0 - t)
    return oc.lr * warm * decay


def init_opt_state(params) -> dict:
    """Zero moments (f32, congruent with ``params``) and step 0."""
    leaves, _ = T.flatten(params)

    def zeros(_, p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"m": T.map_with_path(zeros, params),
            "v": T.map_with_path(zeros, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=leaves[0].device)}


def global_norm(tree) -> torch.Tensor:
    leaves, _ = T.flatten(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in leaves))


def clip_by_global_norm(grads, max_norm):
    """(grads scaled so their global norm is at most ``max_norm``, the
    norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return T.map_with_path(lambda _, g: g * scale, grads), norm


_NO_DECAY = ("scale", "bias", "A_log", "dt_bias", "D")


def _decay_mask(path) -> bool:
    return str(path[-1]) not in _NO_DECAY


def adamw_update(params, grads, opt_state: dict, oc: AdamWConfig, *,
                 grad_norm=None):
    """One AdamW step.  Returns (new_params, new_opt_state, metrics
    {"lr", "grad_norm"}).  Grads go to f32 and are clipped by global norm;
    the step count advances; the moments update and are bias-corrected;
    decay is added to the update, which is applied in f32 and cast to
    each parameter's dtype.  ``grad_norm``: the grads' global norm when
    they are this rank's blocks of a sharded tree (the sharded step sums
    their squares across ranks); by default the norm of ``grads``.

    The new parameters and moments are written into the given tensors,
    which come back (the caller hands them over, as to the JAX package's
    donated buffers): a step holds one copy of each, 24.7 GB at
    qwen2.5-1.5b rather than twice that."""
    # clipping scales each f32 grad as it is used (the reference's
    # clipped tree, without holding a second copy of it)
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    clip = (torch.clamp_max(oc.grad_clip / torch.clamp_min(gnorm, 1e-9),
                            1.0) if oc.grad_clip else None)
    step = opt_state["step"] + 1
    lr = lr_at(step, oc).to(gnorm.device)
    b1c = 1 - oc.b1 ** step.float()
    b2c = 1 - oc.b2 ** step.float()

    def upd(path, p, g, m, v):
        g = g.float() if clip is None else g.float() * clip
        m_new = oc.b1 * m + (1 - oc.b1) * g
        v_new = oc.b2 * v + (1 - oc.b2) * g * g
        mh = m_new / b1c
        vh = v_new / b2c
        delta = mh / (torch.sqrt(vh) + oc.eps)
        if oc.weight_decay and _decay_mask(path):
            delta = delta + oc.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        m.copy_(m_new)
        v.copy_(v_new)
        return p, m, v

    # leaves of ``out`` are (param, m, v) tuples
    out = T.map_with_path(upd, params, grads, opt_state["m"],
                          opt_state["v"])

    def part(i):
        return T.map_with_path(lambda _, t: t[i], out)

    return part(0), {"m": part(1), "v": part(2), "step": step}, {
        "lr": lr, "grad_norm": gnorm}
