"""The direct test-time-scaling path of the port against the JAX package:
``DecodeEngine.generate`` / ``fork`` / ``reorder`` / ``resume`` and stop
ids, Best-of-N, self-consistency and ``controller.sweep`` over both
routes, on the same weights (carried across by ``repro_torch.bridge``)
and prompts, over fp, Q8 and Q4 pools (each held against the reference's
own pool of that kind).  Greedy tokens must match exactly; logprob sums
within the reference's logit tolerance of the pool's kind."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import best_of_n as JB
from repro.core import controller as JC
from repro.core import reward as JR
from repro.core import self_consistency as JSC
from repro.models import api as japi
from repro.serving.engine import DecodeEngine as JEngine
from repro.serving.sampler import SamplerConfig as JSampler
from repro_torch import bridge
from repro_torch.configs.base import ModelConfig
from repro_torch.core import best_of_n as B
from repro_torch.core import controller as C
from repro_torch.core import reward as R
from repro_torch.core import self_consistency as SC
from repro_torch.data import tasks as T
from repro_torch.serving.engine import DecodeEngine
from repro_torch.serving.sampler import SamplerConfig

KVS = ["none", "q8", "q4"]
# logprob sums: f32 sums in two orders on fp pools; on quantized pools the
# reference's own q8 / q4 logit tolerances (tests/test_kv_quant.py)
ATOL = {"none": 1e-4, "q8": 0.05, "q4": 0.8}
MAX_LEN, BLOCK, N_BLOCKS = 64, 8, 96


def _torch_cfg(cfg):
    return ModelConfig(**{f: getattr(cfg, f) for f in (
        "name", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
        "vocab_size", "dtype", "param_dtype")})


class Side:
    """One package's engine behind one greedy API over numpy values."""

    def __init__(self, eng, tok, is_jax: bool):
        self.eng, self.tok, self.is_jax = eng, tok, is_jax

    def prefill(self, texts, plen=32):
        ids, lens = self.tok.encode_batch(texts, plen)
        if self.is_jax:
            return self.eng.prefill(jnp.asarray(ids), jnp.asarray(lens))
        return self.eng.prefill(torch.from_numpy(ids), torch.from_numpy(lens))

    def generate(self, st, n, stop_ids=()):
        if self.is_jax:
            st, out = self.eng.generate(st, n, jax.random.key(0),
                                        JSampler(greedy=True),
                                        stop_ids=stop_ids)
        else:
            st, out = self.eng.generate(st, n, None,
                                        SamplerConfig(greedy=True),
                                        stop_ids=stop_ids)
        return st, self.np(out)

    def reorder(self, st, idx):
        return self.eng.reorder(st, jnp.asarray(idx, jnp.int32)
                                if self.is_jax else np.asarray(idx))

    def fork(self, st, n):
        return self.eng.fork(st, n)

    def resume(self, st):
        return self.eng.resume(st)

    def get(self, st, name):
        return self.np(getattr(st, name))

    def np(self, x):
        return np.asarray(x) if self.is_jax else x.cpu().numpy()

    def release(self, st):
        self.eng.release_rows(st, list(range(self.get(st, "done").shape[0])))

    @property
    def in_use(self):
        return self.eng.pool.blocks_in_use


@pytest.fixture(scope="module")
def jparams(tiny_cfg):
    return japi.get_model(tiny_cfg).init_params(jax.random.key(11), tiny_cfg)


@pytest.fixture(scope="module")
def make_pair(tiny_cfg, tok, jparams):
    """kv -> (reference side, port side) on the same weights, one pair
    per pool kind for the module."""
    made = {}
    tparams = bridge.params_from_jax(jax.device_get(jparams), device="cpu")

    def make(kv):
        if kv not in made:
            j = JEngine(jparams, tiny_cfg, max_len=MAX_LEN, eos_id=tok.eos_id,
                        pad_id=tok.pad_id, paged=True, block_size=BLOCK,
                        n_blocks=N_BLOCKS, kv_quant=kv)
            t = DecodeEngine(tparams, _torch_cfg(tiny_cfg), max_len=MAX_LEN,
                             eos_id=tok.eos_id, pad_id=tok.pad_id,
                             paged=True, block_size=BLOCK,
                             n_blocks=N_BLOCKS, kv_quant=kv)
            made[kv] = (Side(j, tok, True), Side(t, tok, False))
        return made[kv]

    return make


def _both(make_pair, kv, scenario):
    """Run ``scenario(side)`` on both packages; returns (ref, port)
    results, each side's pool drained back to where it started."""
    out = []
    for side in make_pair(kv):
        before = side.in_use
        out.append(scenario(side))
        assert side.in_use == before
    return out


def _assert_same(want, got, kv):
    assert set(want) == set(got)
    for k in want:
        if k in ("logprob_sum",):
            np.testing.assert_allclose(got[k], want[k], atol=ATOL[kv],
                                       err_msg=k)
        elif k in ("pending",):
            continue  # compared within a side only
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kv", KVS)
def test_fork_shares_prefix(make_pair, kv):
    """Fork is a refcount bump (no block allocated), and the greedy copies
    decode identically."""
    def scenario(side):
        st = side.prefill(["Q:3+4=?A:"])
        used = side.in_use
        st = side.fork(st, 4)
        assert side.in_use == used          # shared, not copied
        st, out = side.generate(st, 8)
        assert (out == out[0]).all()
        res = {"out": out, "logprob_sum": side.get(st, "logprob_sum"),
               "n_gen": side.get(st, "n_gen"), "blocks": side.in_use}
        side.release(st)
        return res

    want, got = _both(make_pair, kv, scenario)
    _assert_same(want, got, kv)


@pytest.mark.parametrize("kv", KVS)
def test_reorder_gathers_rows(make_pair, kv):
    """reorder permutes rows, and after a fork (row i -> rows [i*n,
    (i+1)*n)) gathers the replicated rows: a dropped row releases its
    blocks, the gathered rows decode like the originals."""
    def scenario(side):
        st = side.prefill(["Q:1+1=?A:", "Q:2+2=?A:"])
        lens, pend = side.get(st, "cache_len"), side.get(st, "pending_logits")
        st2 = side.reorder(st, [1, 0])
        np.testing.assert_array_equal(side.get(st2, "cache_len"),
                                      lens[[1, 0]])
        np.testing.assert_array_equal(side.get(st2, "pending_logits"),
                                      pend[[1, 0]])
        forked = side.fork(st2, 2)           # rows: [p1, p1, p0, p0]
        picked = side.reorder(forked, [2, 1])  # one copy of each, swapped
        blocks = side.in_use
        np.testing.assert_array_equal(side.get(picked, "pending_logits"),
                                      pend)
        picked, out = side.generate(picked, 8)
        res = {"out": out, "blocks": blocks,
               "logprob_sum": side.get(picked, "logprob_sum")}
        side.release(picked)
        return res

    want, got = _both(make_pair, kv, scenario)
    _assert_same(want, got, kv)


@pytest.mark.parametrize("kv", KVS)
def test_stop_ids_and_resume(make_pair, kv):
    """A row stops at its first stop id and freezes: more steps leave its
    pending logits, length and n_gen alone and emit pad; resume continues
    from the logits that followed the stop token."""
    def scenario(side):
        texts = ["Q:2+3=?A:", "Q:9-1=?A:"]
        st = side.prefill(texts)
        st, free = side.generate(st, 8, stop_ids=(9999,))
        side.release(st)
        # random weights seldom sample '.': stop at tokens the stream has
        stops = (side.eng.eos_id, int(free[0, 3]), int(free[1, 5]))
        st = side.prefill(texts)
        st, out = side.generate(st, 8, stop_ids=stops)
        done = side.get(st, "done")
        frozen = side.get(st, "pending_logits")
        lens = side.get(st, "cache_len")
        st2, more = side.generate(st, 8, stop_ids=stops)
        for b in np.nonzero(done)[0]:
            assert (more[b] == side.eng.pad_id).all()
            np.testing.assert_array_equal(
                side.get(st2, "pending_logits")[b], frozen[b])
            assert side.get(st2, "cache_len")[b] == lens[b]
        st3, first = side.generate(side.resume(st2), 8)
        for b in np.nonzero(done)[0]:
            assert first[b, 0] == int(np.argmax(frozen[b]))
        res = {"out": out, "more": more, "first": first, "done": done,
               "n_gen": side.get(st3, "n_gen"),
               "logprob_sum": side.get(st3, "logprob_sum")}
        side.release(st3)
        return res

    want, got = _both(make_pair, kv, scenario)
    assert want["done"].all()                # the case exercises stops
    _assert_same(want, got, kv)


@pytest.mark.parametrize("kv", KVS)
def test_multi_stop_ids_mask_generation(make_pair, kv):
    """With several stop ids each row stops at its first occurrence of
    any of them, keeps it, and pads afterwards."""
    def scenario(side):
        texts = ["Q:2+3=?A:", "Q:8+1=?A:"]
        st = side.prefill(texts)
        st, free = side.generate(st, 8, stop_ids=(9999,))
        side.release(st)
        stops = tuple({int(free[0, 2]), int(free[1, 3])})
        st = side.prefill(texts)
        st, out = side.generate(st, 8, stop_ids=stops)
        for b in range(2):
            first = next(i for i, t in enumerate(free[b].tolist())
                         if t in stops)
            np.testing.assert_array_equal(out[b, :first], free[b, :first])
            assert out[b, first] in stops
            assert (out[b, first + 1:] == side.eng.pad_id).all()
        assert side.get(st, "done").all()
        side.release(st)
        return {"out": out, "free": free}

    want, got = _both(make_pair, kv, scenario)
    _assert_same(want, got, kv)


def test_generate_plans_the_horizon_once(make_pair):
    """generate allocates every block of its horizon up front (one plan),
    so a row that stops early keeps its surplus blocks until released."""
    ref, port = make_pair("none")
    for side in (ref, port):
        st = side.prefill(["Q:1+2=?A:"])
        before = side.in_use
        st, _ = side.generate(st, 30)
        # 10 prompt tokens + 30 steps = 40 positions: 5 blocks of 8
        assert side.in_use - before == 5 - 2
        side.release(st)


@pytest.mark.parametrize("kv", KVS)
def test_best_of_n_structure(make_pair, tok, kv):
    """The direct Best-of-N: same completions, scores, choice and decode
    cost as the reference, and the task's blocks go back to the pool."""
    task = T.gen_dataset(5, 1, min_terms=2, max_terms=3)[0]
    ref, port = make_pair(kv)
    want = JB.best_of_n(ref.eng, tok, task, n=4, max_tokens=12,
                        rng=jax.random.key(0), scorer=JR.OracleVerifier(),
                        sc=JSampler(greedy=True))
    got = B.best_of_n(port.eng, tok, task, n=4, max_tokens=12,
                      generator=None, scorer=R.OracleVerifier(),
                      sc=SamplerConfig(greedy=True))
    assert port.in_use == 0
    assert len(got.completions) == 4 and got.scores.shape == (4,)
    assert got.completions == want.completions
    assert got.chosen == want.chosen and got.answer == want.answer
    assert got.decode_tokens == want.decode_tokens > 0
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    tasks = T.gen_dataset(6, 2, max_terms=2)
    assert B.evaluate_best_of_n(
        port.eng, tok, tasks, n=4, max_tokens=12, generator=None,
        scorer=R.OracleVerifier(), sc=SamplerConfig(greedy=True)) == \
        JB.evaluate_best_of_n(ref.eng, tok, tasks, n=4, max_tokens=12,
                              rng=jax.random.key(0),
                              scorer=JR.OracleVerifier(),
                              sc=JSampler(greedy=True))
    assert port.in_use == 0


@pytest.mark.parametrize("kv", KVS)
def test_self_consistency_greedy(make_pair, tok, kv):
    task = T.gen_dataset(7, 1)[0]
    ref, port = make_pair(kv)
    want = JSC.self_consistency(ref.eng, tok, task, n=5, max_tokens=12,
                                rng=jax.random.key(0),
                                sc=JSampler(greedy=True))
    got = SC.self_consistency(port.eng, tok, task, n=5, max_tokens=12,
                              generator=None, sc=SamplerConfig(greedy=True))
    assert port.in_use == 0
    assert got.completions == want.completions and len(got.completions) == 5
    assert (got.chosen, got.answer, got.correct, got.decode_tokens) == \
        (want.chosen, want.answer, want.correct, want.decode_tokens)


class _FixedEngine:
    """A stand-in engine whose generate returns fixed completions (the
    vote is held on them: a torch.Generator cannot reproduce jax.random,
    so sampled completions differ between the packages)."""

    paged = False
    eos_id, pad_id = 2, 0

    def __init__(self, tok, texts, xp):
        self.rows = [tok.encode(t, bos=False) for t in texts]
        self.xp = xp
        width = max(map(len, self.rows))
        self.out = np.zeros((len(texts), width), np.int32)
        for i, r in enumerate(self.rows):
            self.out[i, :len(r)] = r

    def prefill(self, ids, lens):
        return None

    def fork(self, st, n):
        assert n == len(self.rows)
        return None

    def generate(self, st, n, *a, **k):
        n_gen = np.array([len(r) for r in self.rows], np.int32)
        if self.xp == "jax":
            return (types.SimpleNamespace(n_gen=jnp.asarray(n_gen)),
                    jnp.asarray(self.out))
        return (types.SimpleNamespace(n_gen=torch.from_numpy(n_gen)),
                torch.from_numpy(self.out))

    def release_rows(self, st, rows):
        return st


@pytest.mark.parametrize("texts", [
    ["3+4=7.A:7", "A:8", "A:7", "A:9", "A:8"],      # majority 7 (first)
    ["A:8", "A:7", "A:7", "A:8", "no answer"],      # 2-2 tie: first counted
    ["no", "answers", "here"],                      # no votes at all
    ["A:12", "A:5", "A:12"],                        # majority the right one
])
def test_self_consistency_vote_matches_reference(tok, texts):
    task = T.MathTask(question="Q:5+7=?", answer=12, reasoning="",
                      difficulty=1)
    want = JSC.self_consistency(_FixedEngine(tok, texts, "jax"), tok, task,
                                n=len(texts), max_tokens=8,
                                rng=jax.random.key(0))
    got = SC.self_consistency(_FixedEngine(tok, texts, "torch"), tok, task,
                              n=len(texts), max_tokens=8, generator=None)
    assert got.completions == want.completions == texts
    assert (got.chosen, got.answer, got.correct, got.decode_tokens) == \
        (want.chosen, want.answer, want.correct, want.decode_tokens)
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))


@pytest.mark.parametrize("continuous", [False, True])
def test_sweep_matches_reference_over_both_routes(monkeypatch, make_pair,
                                                  tok, continuous):
    """sweep over the three methods: continuous routes Best-of-N and beam
    search through the scheduler, the rest (and everything without it)
    takes the direct path; every row equals the reference's.  Both
    ``sweep``s hand ``sc`` to the scheduler rows only; direct rows sample
    with their method's default sampler, which is made greedy here on
    both sides alike, so that their tokens can be compared."""
    from repro.core import beam_search as JBS
    from repro_torch.core import beam_search as BS

    for fn in (JB.best_of_n, JSC.self_consistency, JBS.beam_search):
        monkeypatch.setitem(fn.__kwdefaults__, "sc", JSampler(greedy=True))
    for fn in (B.best_of_n, SC.self_consistency, BS.beam_search):
        monkeypatch.setitem(fn.__kwdefaults__, "sc",
                            SamplerConfig(greedy=True))
    ref, port = make_pair("q8")
    tasks = T.gen_dataset(31, 2, max_terms=2)
    specs = [("best_of_n", 3, {}), ("self_consistency", 3, {}),
             ("beam_search", 4, dict(beam_width=2, beam_expand=2,
                                     beam_steps=2, step_tokens=6))]
    want = JC.sweep(ref.eng, tok, tasks,
                    [JC.TTSSpec(m, b, max_tokens=8, **kw)
                     for m, b, kw in specs],
                    jax.random.key(0), JR.OracleVerifier(),
                    continuous=continuous, n_slots=4,
                    sc=JSampler(greedy=True))
    got = C.sweep(port.eng, tok, tasks,
                  [C.TTSSpec(m, b, max_tokens=8, **kw) for m, b, kw in specs],
                  None, R.OracleVerifier(), continuous=continuous, n_slots=4,
                  sc=SamplerConfig(greedy=True))
    assert port.in_use == 0
    for w, g in zip(want, got):
        for key in ("method", "budget", "accuracy", "decode_tokens"):
            assert g[key] == w[key], (g["method"], key)
        assert ("serving" in g) == ("serving" in w)
        if "serving" in g:
            for key in ("steps", "completed_requests", "completed_samples",
                        "beam_boundaries", "prm_batches", "peak_kv_bytes"):
                assert g["serving"][key] == w["serving"][key], key
    assert ("serving" in got[0]) == continuous
    assert "serving" not in got[1]           # self-consistency: direct
