"""Synthetic *verifiable* math tasks — the MATH500/GSM8K stand-in.

The paper's end-to-end claim (Figs. 5/10) is that accuracy on verifiable
math scales with the parallel-sampling budget.  Reproducing that claim
needs (a) a task family with checkable answers and graded difficulty and
(b) a model imperfect enough that independent samples disagree.  These
chained-arithmetic word problems provide (a); the ~1M-param model trained
in ``examples/tts_math_demo.py`` provides (b).

Format (all ASCII, byte-tokenizer friendly):
    Q:3+4*2=?A:11.
Multi-step "reasoning" variant writes intermediate steps:
    Q:3+4+5=?R:3+4=7.7+5=12.A:12.
The step delimiter '.' is what step-level beam search segments on.
"""
from __future__ import annotations

import dataclasses
import random
import re
from typing import List, Optional, Tuple


@dataclasses.dataclass
class MathTask:
    question: str          # "Q:3+4*2=?"
    answer: int
    reasoning: str         # "R:3+4=7.7+5=12." ("" for direct tasks)
    difficulty: int

    @property
    def prompt(self) -> str:
        return self.question + ("R:" if self.reasoning else "A:")

    @property
    def target(self) -> str:
        if self.reasoning:
            return self.reasoning[2:] + "A:" + str(self.answer) + "."
        return str(self.answer) + "."

    @property
    def full_text(self) -> str:
        return self.prompt + self.target


def gen_task(rng: random.Random, *, n_terms: int = 3, max_operand: int = 9,
             reasoning: bool = True) -> MathTask:
    """Chained additions/subtractions with running-total reasoning steps."""
    terms = [rng.randint(1, max_operand) for _ in range(n_terms)]
    ops = [rng.choice("+-") for _ in range(n_terms - 1)]
    expr = str(terms[0])
    total = terms[0]
    steps = []
    run = terms[0]
    for op, t in zip(ops, terms[1:]):
        expr += op + str(t)
        new = run + t if op == "+" else run - t
        steps.append(f"{run}{op}{t}={new}.")
        run = new
    total = run
    q = f"Q:{expr}=?"
    r = ("R:" + "".join(steps)) if reasoning else ""
    return MathTask(question=q, answer=total, reasoning=r,
                    difficulty=n_terms)


def gen_dataset(seed: int, n: int, *, min_terms: int = 2, max_terms: int = 4,
                max_operand: int = 9, reasoning: bool = True) -> List[MathTask]:
    rng = random.Random(seed)
    return [gen_task(rng, n_terms=rng.randint(min_terms, max_terms),
                     max_operand=max_operand, reasoning=reasoning)
            for _ in range(n)]


# ---------------------------------------------------------------------------
# Shared-prefix prompt building (the cross-request prefix-cache workload)
# ---------------------------------------------------------------------------

SYSTEM_PROMPT = "You solve arithmetic step by step."


def fewshot_header(seed: int = 0, n_shots: int = 3, *,
                   reasoning: bool = False,
                   system_prompt: str = SYSTEM_PROMPT) -> str:
    """A deterministic system-prompt + worked-examples header.

    Test-time-scaling traffic repeats the same instructions and few-shot
    examples in front of every task, so prompts built with one header
    share a long common token prefix across *requests* — exactly what the
    serving layer's cross-request prefix cache
    (the prefix cache) converts into skipped prefill
    compute.  Same (seed, n_shots) -> byte-identical header.
    """
    rng = random.Random(seed)
    shots = [gen_task(rng, n_terms=2, reasoning=reasoning)
             for _ in range(n_shots)]
    return system_prompt + "".join(t.full_text for t in shots)


def with_header(task: MathTask, header: str) -> MathTask:
    """The task with ``header`` prepended to its question: ``prompt`` /
    ``full_text`` then start with the shared prefix while answer checking
    (``verify`` parses the completion, not the prompt) is unchanged."""
    return dataclasses.replace(task, question=header + task.question)


def shared_prefix_dataset(seed: int, n: int, *, n_shots: int = 3,
                          reasoning: bool = False, **gen_kwargs) -> List[MathTask]:
    """``gen_dataset`` with one common few-shot header on every prompt —
    the benchmark/demo workload for the cross-request prefix cache."""
    header = fewshot_header(seed, n_shots, reasoning=reasoning)
    return [with_header(t, header)
            for t in gen_dataset(seed, n, reasoning=reasoning, **gen_kwargs)]


ANSWER_RE = re.compile(r"A:(-?\d+)\.")


def extract_answer(text: str) -> Optional[int]:
    """Pull the final answer out of a generated completion."""
    m = ANSWER_RE.search(text)
    if m:
        try:
            return int(m.group(1))
        except ValueError:
            return None
    # direct-answer format: leading integer
    m = re.match(r"\s*(-?\d+)\.", text)
    return int(m.group(1)) if m else None


def verify(task: MathTask, completion: str) -> bool:
    """Outcome verification (the Best-of-N oracle ORM)."""
    ans = extract_answer(completion if "A:" in completion
                         else "A:" + completion)
    return ans is not None and ans == task.answer


def split_steps(completion: str) -> List[str]:
    """Segment a completion into reasoning steps (for step-level PRM)."""
    parts = [p + "." for p in completion.split(".") if p]
    return parts
