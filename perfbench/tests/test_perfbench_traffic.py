"""The one traffic generator: seeded, repeatable, the same sizes for
every seed, in the cells' parameters."""
import json
from pathlib import Path

import numpy as np
import pytest

import tiny  # noqa: F401

from benchlib import loop as LP
from benchlib import traffic as TR

ROOT = Path(__file__).resolve().parents[1]


def _mix(name):
    return json.loads((ROOT / "traffic" / f"{name}.json").read_text())


def _tasks(mix, seed, n):
    """``n`` tasks, the clients taking turns."""
    s = TR.TaskStream(mix, seed, 151936)
    return [s.next(i % mix["clients"]) for i in range(n)]


@pytest.mark.parametrize("name", ["bon16-gsm8k", "bon16-gsm8k-offline",
                                  "bon4-fewshot"])
def test_same_seed_same_tasks(name):
    mix = _mix(name)
    a, b = _tasks(mix, 2 ** 31 + 7, 130), _tasks(mix, 2 ** 31 + 7, 130)
    for x, y in zip(a, b):
        assert x.out_len == y.out_len and np.array_equal(x.prompt, y.prompt)


@pytest.mark.parametrize("name", ["bon16-gsm8k", "bon16-gsm8k-offline",
                                  "bon4-fewshot"])
def test_every_seed_sends_the_same_sizes(name):
    """Each client's chain of sizes is the same for every seed, in any
    order of submission; only the tokens differ."""
    mix = _mix(name)
    n = 3 * mix["clients"]
    a = _tasks(mix, 1, n)
    s = TR.TaskStream(mix, 2, 151936)
    b = [s.next(c) for c in reversed(range(mix["clients"]))
         for _ in range(3)]
    chains = {}
    for t in a:
        chains.setdefault(t.client, []).append((len(t.prompt), t.out_len))
    for c in range(mix["clients"]):
        assert [(len(t.prompt), t.out_len) for t in b
                if t.client == c] == chains[c]
    assert not np.array_equal(a[0].prompt, b[-3].prompt)
    # a block of the chains holds every quantile once
    block = sorted(t.out_len for t in a[:mix["clients"]])
    assert block == sorted(TR.quantiles(mix["output"], mix["clients"]))


def test_cell_parameters():
    g, f = _mix("bon16-gsm8k"), _mix("bon4-fewshot")
    w = _mix("bon16-gsm8k-offline")
    assert g["clients"] * g["n_samples"] == 1024
    assert w["clients"] * w["n_samples"] == 4096
    assert f["clients"] * f["n_samples"] == 256
    assert TR.max_len(g, LP.BLOCK_SIZE) == 784
    assert TR.max_len(w, LP.BLOCK_SIZE) == 784
    assert TR.max_len(f, LP.BLOCK_SIZE) == 1680
    assert TR.prompt_len(f) == 1152
    assert {k: v for k, v in w.items() if k not in
            ("clients", "sources", "assumed")} == \
        {k: v for k, v in g.items() if k not in
         ("clients", "sources", "assumed")}
    for mix in (g, w, f):
        q = TR.quantiles(mix["output"], mix["clients"])
        assert min(q) >= 32 and max(q) <= 512
        assert sorted(q)[len(q) // 2] in range(150, 171)
        p = TR.quantiles(mix["prompt"], mix["clients"])
        assert min(p) >= 48 and max(p) <= 256


def test_shared_header():
    ts = _tasks(_mix("bon4-fewshot"), 5, 20)
    head = ts[0].prompt[:896]
    for t in ts:
        assert t.header == 896 and np.array_equal(t.prompt[:896], head)
        assert (t.prompt >= TR.FIRST_ID).all()
    assert len({len(t.prompt) for t in ts}) > 1
