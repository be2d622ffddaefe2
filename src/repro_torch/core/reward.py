"""Scorers for test-time scaling (the paper's §2.1 ORM role).

* ``OracleVerifier`` — outcome check against the verifiable task answer
  (the Best-of-N upper bound / coverage, Fig. 5);
* ``LogProbScorer`` — model self-certainty (mean sampled logprob), a
  verifier-free ORM baseline.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.data import tasks as T


class OracleVerifier:
    """Outcome-reward oracle for verifiable tasks."""

    def score_texts(self, task: T.MathTask, completions: Sequence[str]):
        return torch.tensor([1.0 if T.verify(task, c) else 0.0
                             for c in completions], dtype=torch.float32)


class LogProbScorer:
    """Self-certainty ORM: length-normalized cumulative sample logprob."""

    def score_states(self, logprob_sum, n_gen):
        return logprob_sum / torch.clamp_min(n_gen, 1)
