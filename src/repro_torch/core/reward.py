"""Scorers for test-time scaling (the paper's §2.1 ORM and PRM roles).

* ``OracleVerifier`` — outcome check against the verifiable task answer
  (the Best-of-N upper bound / coverage, Fig. 5);
* ``LogProbScorer`` — model self-certainty (mean sampled logprob), a
  verifier-free ORM baseline;
* ``LearnedScorer`` — a value model (a Skywork-PRM stand-in): a small
  transformer trunk with a scalar head scoring (prompt + completion)
  prefixes.  The same model serves as ORM (the full sequence) and PRM
  (each step prefix).  ``bridge_reward_params`` carries the JAX
  package's reward parameters across.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch import bridge
from repro_torch.configs.base import ModelConfig
from repro_torch.data import tasks as T
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as TR


class OracleVerifier:
    """Outcome-reward oracle for verifiable tasks."""

    def score_texts(self, task: T.MathTask, completions: Sequence[str]):
        return torch.tensor([1.0 if T.verify(task, c) else 0.0
                             for c in completions], dtype=torch.float32)


class LogProbScorer:
    """Self-certainty ORM: length-normalized cumulative sample logprob."""

    def score_states(self, logprob_sum, n_gen):
        return logprob_sum / torch.clamp_min(n_gen, 1)


# ---------------------------------------------------------------------------
# Learned scorer (ORM / PRM)
# ---------------------------------------------------------------------------


def reward_config(vocab_size: int, *, d_model: int = 64, n_layers: int = 2,
                  n_heads: int = 4) -> ModelConfig:
    return ModelConfig(
        name="reward", family="transformer", n_layers=n_layers,
        d_model=d_model, n_heads=n_heads, n_kv_heads=n_heads,
        d_ff=d_model * 4, vocab_size=vocab_size, dtype="float32",
        param_dtype="float32", remat="none")


def init_reward_params(cfg: ModelConfig, *, seed: int = 0,
                       device=None) -> dict:
    """Random reward parameters from a seeded generator on ``device``
    (CUDA unless asked otherwise): the transformer trunk without its LM
    head, and a (d_model, 1) scalar head with a bias."""
    trunk = TR.init_params(cfg, seed=seed, device=device)
    trunk.pop("lm_head", None)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    w = torch.randn((cfg.d_model, 1), generator=gen, device=dev)
    return {"trunk": trunk,
            "head": {"w": w / math.sqrt(cfg.d_model),
                     "b": torch.zeros((1,), device=dev)}}


def bridge_reward_params(tree: dict, device=None) -> dict:
    """The port's reward parameters for a host-fetched JAX reward tree
    ({"trunk": stacked transformer tree, "head": {"w", "b"}})."""
    dev = resolve_device(device)
    return {"trunk": bridge.params_from_jax(tree["trunk"], device=dev),
            "head": {k: bridge.to_tensor(v, dev)
                     for k, v in tree["head"].items()}}


def reward_apply(params, tokens, lengths, cfg: ModelConfig):
    """tokens: (B, S) right-padded; lengths: (B,) -> scalar scores (B,)
    (pre-sigmoid) read at each row's last position (the trunk is causal,
    so that position summarizes the row)."""
    x, _ = TR.trunk(params["trunk"], tokens, cfg)
    h = x[torch.arange(tokens.shape[0], device=x.device),
          lengths.long() - 1]
    return L.linear(params["head"], h)[:, 0]


def reward_loss(params, tokens, lengths, labels, cfg: ModelConfig):
    """Binary cross-entropy with logits on (sequence, correct?) pairs, in
    the JAX package's stable form."""
    logits = reward_apply(params, tokens, lengths, cfg)
    return torch.mean(torch.clamp_min(logits, 0) - logits * labels
                      + torch.log1p(torch.exp(-logits.abs())))


class LearnedScorer:
    """ORM / PRM over text (tokenizes internally).

    ``n_forwards`` counts reward-model forward passes, so a caller can
    check that PRM scoring stays batched (one forward per beam boundary,
    not one per candidate)."""

    def __init__(self, params, cfg: ModelConfig, tok: ByteTokenizer,
                 max_len: int = 256):
        self.params = params
        self.cfg = cfg
        self.tok = tok
        self.max_len = max_len
        self.n_forwards = 0
        self.device = params["head"]["w"].device

    def _score_prefixes(self, prefixes: Sequence[str]):
        ids, lens = self.tok.encode_batch(list(prefixes), self.max_len)
        self.n_forwards += 1
        out = reward_apply(self.params, torch.from_numpy(ids).to(self.device),
                           torch.from_numpy(lens).to(self.device), self.cfg)
        return torch.sigmoid(out)

    def score_texts(self, task: T.MathTask, completions: Sequence[str]):
        return self._score_prefixes([task.prompt + c for c in completions])

    @staticmethod
    def _last_step_prefix(task: T.MathTask, completion: str) -> str:
        """The prefix ``score_steps(task, completion)[-1]`` scores: the
        prompt plus every (delimiter-normalized) step of the completion."""
        steps = T.split_steps(completion)
        if not steps:
            return task.prompt + completion
        return task.prompt + "".join(steps)

    def score_steps(self, task: T.MathTask, completion: str):
        """PRM mode: score every step prefix of a completion."""
        prefixes, acc = [], ""
        for s in T.split_steps(completion):
            acc += s
            prefixes.append(task.prompt + acc)
        if not prefixes:
            prefixes = [task.prompt + completion]
        return self._score_prefixes(prefixes)

    def score_step_batch(self, task: T.MathTask,
                         completions: Sequence[str]):
        """PRM mode batched across candidates: the last-step score of every
        completion (``score_steps(task, c)[-1]`` for each ``c``) in one
        forward — what beam search calls at a scoring boundary."""
        return self._score_prefixes(
            [self._last_step_prefix(task, c) for c in completions])


# ---------------------------------------------------------------------------
# Scorer dispatch (shared by the direct beam search and the scheduler)
# ---------------------------------------------------------------------------


def prm_step_scores(prm, task: T.MathTask, completions: Sequence[str],
                    logprob_sum=None, n_gen=None):
    """Score candidate step prefixes with whatever the scorer supports:
    batched PRM (``score_step_batch``) > per-candidate PRM
    (``score_steps``) > outcome scorer (``score_texts``) > state-based
    fallback (``score_states``, needs ``logprob_sum`` / ``n_gen``).
    Returns (n,) scores."""
    if hasattr(prm, "score_step_batch"):
        return prm.score_step_batch(task, completions)
    if hasattr(prm, "score_steps"):
        return torch.tensor([float(prm.score_steps(task, c)[-1])
                             for c in completions])
    if hasattr(prm, "score_texts"):
        return prm.score_texts(task, completions)
    return prm.score_states(logprob_sum, n_gen)


def prm_final_scores(prm, task: T.MathTask, completions: Sequence[str],
                     logprob_sum=None, n_gen=None):
    """Final-selection scores over surviving beams: the full-sequence ORM
    view (``score_texts``) when available, else the state-based
    fallback."""
    if hasattr(prm, "score_texts"):
        return prm.score_texts(task, completions)
    return prm.score_states(logprob_sum, n_gen)
