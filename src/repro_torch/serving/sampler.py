"""Token sampling: greedy, temperature, top-k and top-p (nucleus)."""
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
    u = torch.rand(x.shape, generator=generator, device=x.device)
    g = -torch.log(-torch.log(u.clamp(1e-20, 1.0)))
    return torch.argmax(x + g, dim=-1).to(torch.int32)


def logprobs_of(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Per-token log-probabilities. (B, V), (B,) -> (B,)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    return torch.gather(lp, -1, tokens.long()[:, None])[:, 0]
