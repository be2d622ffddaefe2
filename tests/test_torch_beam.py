"""PRM beam search in the port against the JAX package: the scheduler's
beam request class and the direct ``core.beam_search`` path (greedy
parity with each other and with the reference on fp and Q8 pools, and
the same survivors at every scoring boundary), mixed beam + chat +
Best-of-N queues (with and without speculative rounds for the chat
rows), preemption of starved trees, batched PRM scoring with the reward
model carried across (``core.reward.bridge_reward_params``), block
release on success and error, submit validation and the prefix cache."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import beam_search as JBS
from repro.core import controller as JC
from repro.core import reward as JR
from repro.models import api as japi
from repro.serving.engine import BeamSpec as JBeamSpec
from repro.serving.engine import ContinuousScheduler as JScheduler
from repro.serving.engine import DecodeEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.engine import SpecConfig as JSpecConfig
from repro.serving.prefix_cache import PrefixCache as JPrefixCache
from repro.serving.sampler import SamplerConfig as JSampler
from repro_torch import bridge
from repro_torch.configs.base import ModelConfig
from repro_torch.core import controller as C
from repro_torch.core import reward as R
from repro_torch.core.beam_search import beam_search
from repro_torch.data import tasks as T
from repro_torch.serving.engine import (BeamSpec, ContinuousScheduler,
                                        DecodeEngine, Request, SpecConfig)
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.sampler import SamplerConfig

NO_STOP = (9999,)
GREEDY, JGREEDY = SamplerConfig(greedy=True), JSampler(greedy=True)
# small enough to finish fast, large enough for > 1 scoring boundary
WIDTH, EXPAND, STEP_TOKENS, MAX_STEPS = 2, 2, 6, 2
PROMPT_LEN = 16


def _torch_cfg(cfg):
    return ModelConfig(**{f: getattr(cfg, f) for f in (
        "name", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
        "vocab_size", "dtype", "param_dtype")})


@pytest.fixture(scope="module")
def weights(tiny_cfg):
    jp = japi.get_model(tiny_cfg).init_params(jax.random.key(11), tiny_cfg)
    return jp, bridge.params_from_jax(jax.device_get(jp), device="cpu")


@pytest.fixture(scope="module")
def engines(weights, tiny_cfg, tok):
    """(kind, n_blocks) -> (reference engine, port engine), built once."""
    made = {}

    def make(kv="none", n_blocks=48):
        if (kv, n_blocks) not in made:
            kw = dict(max_len=64, eos_id=tok.eos_id, pad_id=tok.pad_id,
                      block_size=8, n_blocks=n_blocks, kv_quant=kv)
            made[kv, n_blocks] = (
                JEngine(weights[0], tiny_cfg, paged=True, **kw),
                DecodeEngine(weights[1], _torch_cfg(tiny_cfg), paged=True,
                             **kw))
        return made[kv, n_blocks]

    return make


@pytest.fixture(scope="module")
def prms(tok):
    """A random reward model in both packages, on the same weights."""
    jcfg = JR.reward_config(tok.vocab_size)
    jp = JR.init_reward_params(jax.random.key(1), jcfg)
    tcfg = R.reward_config(tok.vocab_size)
    tp = R.bridge_reward_params(jax.device_get(jp), device="cpu")
    return JR.LearnedScorer(jp, jcfg, tok), R.LearnedScorer(tp, tcfg, tok)


def _beam_tasks(n):
    return T.gen_dataset(17, n, max_terms=2)


def _direct(engine, tok, task, prm, *, ref=False):
    if ref:
        return JBS.beam_search(engine, tok, task, width=WIDTH, expand=EXPAND,
                               max_steps=MAX_STEPS, step_tokens=STEP_TOKENS,
                               rng=jax.random.key(0), prm=prm, sc=JGREEDY,
                               prompt_len=PROMPT_LEN)
    return beam_search(engine, tok, task, width=WIDTH, expand=EXPAND,
                       max_steps=MAX_STEPS, step_tokens=STEP_TOKENS,
                       generator=None, prm=prm, sc=GREEDY,
                       prompt_len=PROMPT_LEN)


def _served(engine, tok, tasks, prm, *, ref=False, prefix_cache=None):
    mod, kw = (JC, dict(rng=jax.random.key(0), sc=JGREEDY)) if ref else \
        (C, dict(rng=None, sc=GREEDY))
    return mod.serve_beam_search(engine, tok, tasks, width=WIDTH,
                                 expand=EXPAND, step_tokens=STEP_TOKENS,
                                 max_steps=MAX_STEPS, prm=prm, n_slots=8,
                                 prompt_len=PROMPT_LEN,
                                 prefix_cache=prefix_cache, **kw)


def _record_reorders(monkeypatch, engine):
    """Record every ``reorder`` index an engine commits (the survivors of
    each scoring boundary)."""
    seen = []
    orig = engine.reorder

    def recording(state, idx):
        seen.append(np.asarray(jax.device_get(idx) if not torch.is_tensor(idx)
                               else idx).ravel().tolist())
        return orig(state, idx)

    monkeypatch.setattr(engine, "reorder", recording)
    return seen


def _same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.completions == w.completions
        assert (g.chosen, g.answer) == (w.chosen, w.answer)


@pytest.mark.parametrize("kv", ["none", "q8"])
def test_scheduler_beam_matches_direct_and_reference(monkeypatch, engines,
                                                     prms, tok, kv):
    """Greedy beam search: the scheduler's beam class equals the direct
    path, both equal the reference's, every boundary keeps the same
    survivors in both packages, the PRM runs one batched forward per
    boundary, and every block goes back to the pool."""
    jeng, teng = engines(kv)
    jprm, tprm = prms if kv == "none" else (JR.LogProbScorer(),
                                            R.LogProbScorer())
    tasks = _beam_tasks(2)
    jtree = _record_reorders(monkeypatch, jeng)
    ttree = _record_reorders(monkeypatch, teng)
    want_direct = [_direct(jeng, tok, t, jprm, ref=True) for t in tasks]
    got_direct = [_direct(teng, tok, t, tprm) for t in tasks]
    assert teng.pool.blocks_in_use == 0      # the direct path releases
    assert ttree == jtree and len(ttree) >= 2
    _same_results(got_direct, want_direct)
    for g, w in zip(got_direct, want_direct):
        assert g.decode_tokens == w.decode_tokens
    del jtree[:], ttree[:]
    want = _served(jeng, tok, tasks, jprm, ref=True)
    base = getattr(tprm, "n_forwards", 0)
    got = _served(teng, tok, tasks, tprm)
    assert teng.pool.blocks_in_use == 0      # the scheduler drains clean
    assert ttree == jtree and len(ttree) >= 1
    _same_results(got["results"], got_direct)
    _same_results(got["results"], want["results"])
    s, ws = got["serving"], want["serving"]
    for key in ("completed_requests", "completed_samples", "beam_boundaries",
                "beam_expansions", "beam_prunes", "prm_batches",
                "prm_candidates", "steps", "decode_tokens"):
        assert s[key] == ws[key], key
    assert s["completed_samples"] == 2 * WIDTH
    assert s["beam_expansions"] == s["beam_prunes"]
    assert s["prm_candidates_per_batch"] > 1.0   # really batched
    if kv == "none":
        assert tprm.n_forwards - base == s["prm_batches"]


def _mean_logprob_spec(tok, spec_cls, delim="."):
    """A tokenizer-free BeamSpec scoring mean sampled logprob."""
    def score(token_lists, lp, ng):
        return np.asarray(lp) / np.maximum(np.asarray(ng), 1)

    return spec_cls(width=WIDTH, expand=EXPAND, step_tokens=STEP_TOKENS,
                    max_steps=MAX_STEPS,
                    step_stop_id=int(tok.encode(delim, bos=False)[0]),
                    score=score)


def _mixed_queue(engine, tok, *, ref, n_slots=8, delim=".", spec=False):
    """A tree, two chat requests and (at 8 slots) a Best-of-2 group in one
    scheduler; ``spec``: self-drafting speculative rounds (k 4)."""
    sched_cls, req_cls, spec_cls = (JScheduler, JRequest, JBeamSpec) if ref \
        else (ContinuousScheduler, Request, BeamSpec)
    if spec:
        spec = (JSpecConfig if ref else SpecConfig)(k=4, self_draft=True)

    def prompt(text):
        ids = tok.encode(text)
        return jnp.asarray(ids) if ref else torch.tensor(ids,
                                                         dtype=torch.int32)

    sched = sched_cls(engine, n_slots=n_slots, prompt_len=PROMPT_LEN,
                      stop_ids=NO_STOP, spec=spec or None)
    sched.submit(req_cls(req_id=0, prompt=prompt(_beam_tasks(1)[0].prompt),
                         search=_mean_logprob_spec(tok, spec_cls, delim)))
    sched.submit(req_cls(req_id=1, prompt=prompt("Q:7+5=?A:"),
                         max_new_tokens=10))
    sched.submit(req_cls(req_id=2, prompt=prompt("Q:19+23=?A:"),
                         max_new_tokens=10))
    if n_slots >= 8:
        sched.submit(req_cls(req_id=3, prompt=prompt("Q:2+2=?A:"),
                             max_new_tokens=8, n_samples=2))
    res = sched.run(jax.random.key(0) if ref else None,
                    JGREEDY if ref else GREEDY)
    return sched, res


def _solo(engine, tok, text, max_new):
    """One request decoded alone with the scheduler's padding."""
    ids = tok.encode(text)
    padded = torch.zeros((1, PROMPT_LEN), dtype=torch.int32)
    padded[0, :len(ids)] = torch.tensor(ids)
    st = engine.prefill(padded, torch.tensor([len(ids)], dtype=torch.int32))
    st, out = engine.generate(st, max_new, None, GREEDY, stop_ids=NO_STOP)
    engine.release_rows(st, [0])
    return out[0].tolist()


def test_mixed_queue_beam_chat_bon(engines, tok):
    """A tree, plain chat requests and a Best-of-N fan-out share one slot
    pool: the per-row stops touch only the tree's lanes (chat rows match
    a solo run), results equal the reference's, the pool drains."""
    jeng, teng = engines()
    jsched, want = _mixed_queue(jeng, tok, ref=True)
    sched, got = _mixed_queue(teng, tok, ref=False)
    assert got == want and set(got) == {0, 1, 2, 3}
    for rid, text in ((1, "Q:7+5=?A:"), (2, "Q:19+23=?A:")):
        assert got[rid] == _solo(teng, tok, text, 10)
    assert len(got[0]) == WIDTH and len(got[3]) == 2
    assert all(s.finish_reason == "beam" for s in sched.completed[0])
    b, wb = sched.beam_results[0], jsched.beam_results[0]
    assert (b["chosen"], b["beam_steps"]) == (wb["chosen"], wb["beam_steps"])
    np.testing.assert_allclose(b["scores"], wb["scores"], atol=1e-4)
    assert sched.metrics.summary()["beam_boundaries"] >= 1
    assert teng.pool.blocks_in_use == 0


def test_beam_lane_frozen_during_spec_verify_resumes_clean(engines, tok):
    """Freeze and resume under speculation: beam lanes never draft (they
    ride every verify round at one committed token, so the boundary
    bookkeeping stays stepwise), and a lane frozen at its step budget
    while the chat rows still speculate resumes from its committed state
    with no draft residue.  The delimiter 'z' is never sampled, so every
    lane takes the freeze path at each boundary.  The whole mixed queue
    equals the spec-disabled run and the reference's speculative run."""
    jeng, teng = engines()
    _, base = _mixed_queue(teng, tok, ref=False, delim="z")
    sched, got = _mixed_queue(teng, tok, ref=False, delim="z", spec=True)
    jsched, want = _mixed_queue(jeng, tok, ref=True, delim="z", spec=True)
    assert got == base == want    # incl. the frozen-then-resumed lanes
    b = sched.beam_results[0]
    assert b["beam_steps"] == jsched.beam_results[0]["beam_steps"]
    s, ws = sched.metrics.summary(), jsched.metrics.summary()
    for key in ("spec_rounds", "draft_tokens", "steps", "decode_tokens",
                "beam_boundaries"):
        assert s[key] == ws[key], key
    assert s["spec_rounds"] > 0       # chat rows really speculated...
    assert s["beam_boundaries"] >= 1  # ...across a freeze boundary
    for rid, text in ((1, "Q:7+5=?A:"), (2, "Q:19+23=?A:")):
        assert got[rid] == _solo(teng, tok, text, 10)
    assert teng.pool.blocks_in_use == 0


def test_beam_preempted_under_block_pressure(engines, tok):
    """On a starved pool the tree's copy-on-write growth preempts the
    youngest request; everything still completes as in the reference and
    the pool drains.  The delimiter 'z' is never sampled, so every lane
    runs its whole step budget and is frozen at each boundary."""
    jeng, teng = engines(n_blocks=10)
    jsched, want = _mixed_queue(jeng, tok, ref=True, n_slots=6, delim="z")
    sched, got = _mixed_queue(teng, tok, ref=False, n_slots=6, delim="z")
    assert got == want and len(got[0]) == WIDTH
    p = sched.metrics.summary()["preemptions"]
    assert p >= 1 and p == jsched.metrics.summary()["preemptions"]
    assert teng.pool.blocks_in_use == 0


def test_prm_step_batch_matches_sequential(prms):
    """score_step_batch scores every candidate's last step in one forward,
    equal to per-candidate score_steps, and to the reference's scores."""
    jprm, prm = prms
    task = T.gen_dataset(23, 1)[0]
    comps = ["3+4=7.", "3+4=8.", "3+4=7.7+5=12.", "no delimiter yet"]
    seq = np.asarray([float(prm.score_steps(task, c)[-1]) for c in comps])
    base = prm.n_forwards
    batch = prm.score_step_batch(task, comps).numpy()
    assert prm.n_forwards == base + 1
    np.testing.assert_allclose(batch, seq, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        batch, np.asarray(jprm.score_step_batch(task, comps)), atol=1e-5)


def test_direct_beam_search_releases_blocks(engines, tok):
    """The direct path frees every block it held, on return and when the
    PRM raises mid-search."""

    class Boom:
        def score_texts(self, task, texts):
            raise RuntimeError("prm fell over")

    _, teng = engines()
    r = _direct(teng, tok, _beam_tasks(1)[0], R.LogProbScorer())
    assert len(r.completions) == WIDTH
    assert teng.pool.blocks_in_use == 0
    with pytest.raises(RuntimeError, match="prm fell over"):
        _direct(teng, tok, _beam_tasks(1)[0], Boom())
    assert teng.pool.blocks_in_use == 0


def test_beam_submit_validation(engines, tok):
    sched = ContinuousScheduler(engines()[1], n_slots=4,
                                prompt_len=PROMPT_LEN)
    prompt = torch.tensor(tok.encode("Q:1+2=?A:"), dtype=torch.int32)
    spec = _mean_logprob_spec(tok, BeamSpec)
    with pytest.raises(ValueError, match="mutually exclusive"):
        sched.submit(Request(req_id=0, prompt=prompt, n_samples=2,
                             search=spec))
    with pytest.raises(ValueError, match="score is required"):
        sched.submit(Request(req_id=1, prompt=prompt,
                             search=BeamSpec(width=2, expand=2,
                                             step_stop_id=46)))
    with pytest.raises(ValueError, match="step_stop_id"):
        sched.submit(Request(req_id=2, prompt=prompt,
                             search=BeamSpec(width=2, expand=2,
                                             score=spec.score)))
    with pytest.raises(ValueError, match="exceeds n_slots"):
        sched.submit(Request(req_id=3, prompt=prompt,
                             search=BeamSpec(width=4, expand=2,
                                             step_stop_id=46,
                                             score=spec.score)))
    with pytest.raises(ValueError, match="must all be >= 1"):
        sched.submit(Request(req_id=4, prompt=prompt,
                             search=BeamSpec(width=2, expand=0,
                                             step_stop_id=46,
                                             score=spec.score)))


def test_beam_with_prefix_cache(engines, weights, tiny_cfg, tok):
    """A finished tree inserts its prompt into the prefix cache; the same
    task again admits through a cache hit, reproduces the uncached run
    and matches the reference, and the pool keeps only the cache's pins."""
    jeng, _ = engines("none", 47)
    teng = DecodeEngine(weights[1], _torch_cfg(tiny_cfg), max_len=64,
                        eos_id=tok.eos_id, pad_id=tok.pad_id, paged=True,
                        block_size=8, n_blocks=47)
    jcache, cache = JPrefixCache(jeng.pool), PrefixCache(teng.pool)
    tasks = _beam_tasks(1)
    rows = [_served(teng, tok, tasks, R.LogProbScorer(), prefix_cache=cache)
            for _ in range(2)]
    want = [_served(jeng, tok, tasks, JR.LogProbScorer(), ref=True,
                    prefix_cache=jcache) for _ in range(2)]
    assert cache.stats()["hits"] >= 1 and cache.stats()["cached_blocks"] >= 1
    assert teng.pool.blocks_in_use == cache.stats()["cached_blocks"]
    _same_results(rows[1]["results"], rows[0]["results"])
    _same_results(rows[1]["results"], want[1]["results"])
    assert cache.stats()["hits"] == jcache.stats()["hits"]


def test_beam_search_runs(engines, tok):
    _, teng = engines()
    task = T.gen_dataset(9, 1, max_terms=2)[0]
    r = beam_search(teng, tok, task, width=2, expand=2, max_steps=3,
                    step_tokens=10, generator=torch.Generator().manual_seed(0),
                    prm=R.LogProbScorer())
    assert len(r.completions) == 2 and r.decode_tokens > 0
    assert teng.pool.blocks_in_use == 0


def test_learned_scorer_api(tok):
    cfg = R.reward_config(tok.vocab_size)
    sc = R.LearnedScorer(R.init_reward_params(cfg, seed=0, device="cpu"),
                         cfg, tok)
    task = T.gen_dataset(13, 1)[0]
    scores = sc.score_texts(task, ["11.", "7."])
    assert scores.shape == (2,)
    assert ((scores >= 0) & (scores <= 1)).all()
    assert sc.score_steps(task, "3+4=7.7+5=12.A:12.").shape[0] == 3
