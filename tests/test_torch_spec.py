"""Speculative decoding and the dense KV layout of the port against the
JAX package, on the same random ``tiny_cfg`` weights (carried across by
``repro_torch.bridge``).

Speculative greedy decoding must leave the tokens of plain greedy
decoding untouched: the port's speculative tokens equal its plain tokens
and the JAX scheduler's speculative tokens, with the same rounds, draft
tokens and per-round accepted counts, over fp, Q8 and Q4 pools, exact
and LUT softmax (on Q4 the reference's own speculative tokens leave its
plain ones on these weights: the verify attends the proposals' fresh KV,
a plain step their Q4 round trip; the port leaves its plain tokens
exactly where the reference does), self-drafting and a registry draft model (its weights
bridged from the JAX drafter), a starved pool (``OutOfBlocks`` inside
the draft and at the verify), ``no_spec`` rows, a non-greedy fallback and
committed stop tokens; every pool drains.  The dense layout the drafter
runs on: ``decode_attention`` (ring and window), prefill / decode /
``forced_step`` logits, ``fork`` / ``reorder`` / ``generate``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import api as japi
from repro.models import layers as JL
from repro.serving.engine import ContinuousScheduler as JScheduler
from repro.serving.engine import DecodeEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.engine import SpecConfig as JSpecConfig
from repro.serving.sampler import SamplerConfig as JSampler
from repro_torch import bridge
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.serving.engine import (ContinuousScheduler, DecodeEngine,
                                        Request, SpecConfig)
from repro_torch.serving.kv_pool import OutOfBlocks
from repro_torch.serving.sampler import SamplerConfig

GREEDY, JGREEDY = SamplerConfig(greedy=True), JSampler(greedy=True)
NO_STOP = (9999,)
REQS = [("Q:2+7=?A:", 12), ("Q:1+1=?A:", 6), ("Q:9+9=?A:", 10),
        ("Q:4+5=?A:", 8)]
MAX_LEN, BLOCK, PROMPT_LEN, N_SLOTS = 64, 8, 16, 3
# the JAX package's paged-attention impl that matches each of the port's
IMPL = {"exact": "xla", "lut": "kernel_lut"}
# f32 on both sides, summed in other orders (tests/test_torch_model.py)
ATOL = 1e-5


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
    """(kv, impl, n_blocks) -> (reference engine, port engine), paged,
    built once: the reference's jit caches live on its engine, and its
    impl is read when they trace.  ``make.drafter`` keeps the reference
    scheduler's first dense draft engine, which later reference
    schedulers reuse (same config and seed-0 weights, compiled once)."""
    made = {}

    def make(kv="none", impl="exact", n_blocks=48):
        key = (kv, impl, n_blocks)
        if key not in made:
            kw = dict(max_len=MAX_LEN, eos_id=tok.eos_id, pad_id=tok.pad_id,
                      paged=True, block_size=BLOCK, n_blocks=n_blocks,
                      kv_quant=kv)
            made[key] = (JEngine(weights[0], tiny_cfg, **kw),
                         DecodeEngine(weights[1], _torch_cfg(tiny_cfg), **kw))
        return made[key]

    make.drafter = {}
    return make


def _serve(engine, tok, *, ref, spec=None, impl="exact", stop_ids=NO_STOP,
           no_spec=False, bon=True, reqs=REQS, n_slots=N_SLOTS, sc=None,
           draft_params=None, drafter=None):
    """The REQS queue (plus a Best-of-2 group) through one package's
    scheduler.  Returns (results, summary, per-round accepted counts,
    scheduler); the pool must drain."""
    rounds: list = []
    verify = engine.spec_verify

    def recording(*a, **kw):
        st, commit = verify(*a, **kw)
        rounds.append(np.asarray(commit).sum(axis=1).tolist())
        return st, commit

    mod_sched, mod_req = (JScheduler, JRequest) if ref else \
        (ContinuousScheduler, Request)

    def prompt(text):
        ids = tok.encode(text)
        return jnp.asarray(ids) if ref else torch.tensor(ids,
                                                         dtype=torch.int32)

    if ref:
        prev = JL.set_paged_attention_impl(IMPL[impl])
    else:
        prev = L.set_paged_attention_impl(impl)
    mp = pytest.MonkeyPatch()
    mp.setattr(engine, "spec_verify", recording)
    try:
        sched = mod_sched(engine, n_slots=n_slots, prompt_len=PROMPT_LEN,
                          stop_ids=stop_ids, spec=spec)
        if draft_params is not None:
            sched._draft.params = draft_params
        if drafter is not None and sched._draft is not None:
            sched._draft = drafter.setdefault("engine", sched._draft)
            sched._draft_state = sched._draft.empty_state(n_slots)
        for i, (text, max_new) in enumerate(reqs):
            sched.submit(mod_req(req_id=i, prompt=prompt(text),
                                 max_new_tokens=max_new, no_spec=no_spec))
        if bon:
            sched.submit(mod_req(req_id=len(reqs), prompt=prompt(reqs[0][0]),
                                 max_new_tokens=8, n_samples=2))
        if ref:
            res = sched.run(jax.random.key(0), sc or JGREEDY)
        else:
            res = sched.run(torch.Generator().manual_seed(0), sc or GREEDY)
    finally:
        mp.undo()
        (JL if ref else L).set_paged_attention_impl(prev)
    assert engine.pool.blocks_in_use == 0, "speculative run leaked blocks"
    return res, sched.metrics.summary(), rounds, sched


def _spec_pair(mode):
    if mode == "self":
        return JSpecConfig(k=4, self_draft=True), SpecConfig(k=4,
                                                             self_draft=True)
    return (JSpecConfig(k=4, draft_model="qwen2.5-1.5b"),
            SpecConfig(k=4, draft_model="qwen2.5-1.5b"))


def _assert_same_rounds(got, want):
    for key in ("spec_rounds", "draft_tokens", "spec_acceptance_rate",
                "accepted_tokens_per_step", "decode_tokens", "steps",
                "preemptions", "completed_samples"):
        assert got[1][key] == pytest.approx(want[1][key]), key
    assert got[2] == want[2]              # per-round accepted counts


def _both_spec(engines, tok, kv, impl, mode, **kw):
    """(port plain, port speculative, reference speculative) runs."""
    jeng, teng = engines(kv, impl, kw.pop("n_blocks", 48))
    jspec, tspec = _spec_pair(mode)
    plain = _serve(teng, tok, ref=False, impl=impl, **kw)
    want = _serve(jeng, tok, ref=True, spec=jspec, impl=impl,
                  drafter=engines.drafter, **kw)
    draft = None
    if mode == "draft":
        draft = bridge.params_from_jax(jax.device_get(want[3]._draft.params),
                                       device="cpu")
    got = _serve(teng, tok, ref=False, spec=tspec, impl=impl,
                 draft_params=draft, **kw)
    return plain, got, want


@pytest.mark.parametrize("mode", ["self", "draft"])
@pytest.mark.parametrize("impl", ["exact", "lut"])
@pytest.mark.parametrize("kv", ["none", "q8", "q4"])
def test_spec_greedy_parity_grid(engines, tok, kv, impl, mode):
    """Speculative greedy = plain greedy = the reference's speculative
    greedy, token for token, with its rounds and acceptance, on every
    pool and softmax, for self-drafting and the draft model."""
    plain, got, want = _both_spec(engines, tok, kv, impl, mode)
    assert got[0] == want[0], f"{kv}/{impl}/{mode}: diverged from the JAX"
    _assert_same_rounds(got, want)
    if kv == "q4":
        # the reference's speculative q4 tokens leave its plain ones on
        # some rows: the port's must leave them on the same rows
        jplain = _serve(engines(kv, impl)[0], tok, ref=True, impl=impl)
        assert plain[0] == jplain[0]
        assert {k for k in got[0] if got[0][k] != plain[0][k]} == \
            {k for k in want[0] if want[0][k] != jplain[0][k]}
    else:
        assert got[0] == plain[0], f"{kv}/{impl}/{mode}: diverged from plain"
    s = got[1]
    assert s["spec_rounds"] > 0 and s["draft_tokens"] > 0
    assert s["steps"] < plain[1]["steps"] or mode == "draft"
    if mode == "self":
        # the target drafting for itself greedily: every draft agrees
        assert s["spec_acceptance_rate"] == 1.0
        assert 1 < s["accepted_tokens_per_step"] <= 4
    else:
        assert s["accepted_tokens_per_step"] >= 1


@pytest.mark.parametrize("mode", ["self", "draft"])
@pytest.mark.parametrize("kv", ["none", "q8"])
def test_spec_starved_pool_matches_reference(monkeypatch, engines, tok, kv,
                                             mode):
    """A pool too small for every slot's speculative growth.  Self-draft:
    the snapshot's draft steps run out of blocks, the snapshot's
    references are dropped and the round falls back to a plain step.
    Draft model (which holds no blocks): the verify's W-token plan raises
    ``OutOfBlocks``, preemption reruns the round.  Either way nothing
    leaks, and the tokens, rounds and preemptions equal the plain run's
    and the reference's."""
    _, teng = engines(kv, "exact", 8)
    fell_back, raised = [0], [0]
    draft = ContinuousScheduler._draft_proposals_self

    def drafting(self, *a, **kw):
        ok = draft(self, *a, **kw)
        fell_back[0] += not ok
        return ok

    verify = teng.spec_verify

    def verifying(*a, **kw):
        try:
            return verify(*a, **kw)
        except OutOfBlocks:
            raised[0] += 1
            raise

    monkeypatch.setattr(ContinuousScheduler, "_draft_proposals_self",
                        drafting)
    monkeypatch.setattr(teng, "spec_verify", verifying)
    plain, got, want = _both_spec(engines, tok, kv, "exact", mode,
                                  n_blocks=8)
    assert got[0] == plain[0] == want[0]
    _assert_same_rounds(got, want)
    assert got[1]["preemptions"] > 0 and got[1]["spec_rounds"] > 0
    assert (fell_back if mode == "self" else raised)[0] > 0


def test_spec_committed_stop_and_opt_outs(engines, tok):
    """A stop id committed inside a round ends its row there (the stop
    excluded, as in a plain step); ``no_spec`` rows ride plain rounds
    (zero draft tokens); non-greedy sampling serves plain steps, equal to
    the spec-disabled run for the same generator."""
    jeng, teng = engines()
    plain = _serve(teng, tok, ref=False)
    # the first token request 0 emits new at position >= 2 becomes the
    # stop id: the row stops there, mid-round
    toks = plain[0][0]
    at = next(p for p in range(2, len(toks)) if toks[p] not in toks[:p])
    stop = (int(toks[at]),)
    jspec, tspec = _spec_pair("self")
    base = _serve(teng, tok, ref=False, stop_ids=stop)
    got = _serve(teng, tok, ref=False, spec=tspec,
                 stop_ids=stop)
    want = _serve(jeng, tok, ref=True, spec=jspec,
                  stop_ids=stop)
    assert got[0] == base[0] == want[0]
    assert len(got[0][0]) == at               # stopped at the stop token
    _assert_same_rounds(got, want)
    opted = _serve(teng, tok, ref=False, spec=tspec,
                   no_spec=True, bon=False)
    assert opted[0] == {k: v for k, v in plain[0].items() if k < len(REQS)}
    assert opted[1]["draft_tokens"] == opted[1]["spec_rounds"] == 0
    hot = SamplerConfig(temperature=0.8)
    sampled = [_serve(teng, tok, ref=False, spec=spec, sc=hot)
               for spec in (None, tspec)]
    assert sampled[0][0] == sampled[1][0]
    assert sampled[1][1]["spec_rounds"] == 0


def test_spec_config_validation(weights, tiny_cfg, tok):
    with pytest.raises(ValueError, match="must be >= 2"):
        SpecConfig(k=1, self_draft=True)
    with pytest.raises(ValueError, match="exactly one"):
        SpecConfig(k=4)
    with pytest.raises(ValueError, match="exactly one"):
        SpecConfig(k=4, draft_model="qwen2.5-1.5b", self_draft=True)
    cfg = _torch_cfg(tiny_cfg)
    with pytest.raises(ValueError, match="paged"):
        DecodeEngine(weights[1], cfg, kv_quant="q8")
    dense = DecodeEngine(weights[1], cfg, max_len=MAX_LEN, eos_id=tok.eos_id,
                         pad_id=tok.pad_id)
    with pytest.raises(ValueError, match="paged"):
        ContinuousScheduler(dense, n_slots=2,
                            spec=SpecConfig(k=4, self_draft=True))
    st = dense.prefill(torch.ones((1, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="paged"):
        dense.spec_verify(st, np.ones((1, 2), np.int32),
                          np.ones((1,), np.int32))
    with pytest.raises(ValueError, match="paged"):
        dense.spec_snapshot(st, [0])
    with pytest.raises(ValueError, match="cached-prefix"):
        dense.prefill(torch.ones((1, 8), dtype=torch.int32),
                      cached_table=np.zeros((1, 1), np.int32),
                      cached_lens=np.array([8]))
    paged = DecodeEngine(weights[1], cfg, max_len=MAX_LEN, paged=True,
                         block_size=BLOCK, n_blocks=8)
    pst = paged.prefill(torch.ones((1, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="dense"):
        paged.forced_step(pst, torch.ones((1,), dtype=torch.int32))
    paged.release_rows(pst, [0])
    assert paged.pool.blocks_in_use == 0


# ---------------------------------------------------------------------------
# the dense layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ring,window", [(False, 0), (False, 5), (True, 0),
                                         (True, 6)])
def test_decode_attention_matches_reference(ring, window):
    rng = np.random.default_rng(3)
    B, S, Hkv, G, D = 3, 12, 2, 3, 16
    q = rng.standard_normal((B, 1, Hkv * G, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    # a ring holds the newest S positions of longer sequences
    lens = np.array([1, 7, 29] if ring else [1, 7, 12], np.int32)
    want = JL.decode_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), cache_len=jnp.asarray(lens),
                               window=window, softcap=0.0, ring=ring)
    got = L.decode_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                             cache_len=torch.from_numpy(lens), window=window,
                             ring=ring)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    slots = torch.arange(S)[None]
    pos = L.ring_slot_positions(slots, torch.from_numpy(lens)[:, None], S)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(
        JL.ring_slot_positions(jnp.arange(S)[None],
                               jnp.asarray(lens)[:, None], S)))


@pytest.fixture(scope="module")
def dense_pair(weights, tiny_cfg, tok):
    kw = dict(max_len=32, eos_id=tok.eos_id, pad_id=tok.pad_id)
    return (JEngine(weights[0], tiny_cfg, **kw),
            DecodeEngine(weights[1], _torch_cfg(tiny_cfg), **kw))


def _prompts(tok, texts):
    ids, lens = tok.encode_batch(texts, PROMPT_LEN)
    return ids, lens


def test_dense_prefill_decode_forced_logits_match_reference(dense_pair, tok):
    """Dense prefill, greedy decode steps and ``forced_step`` (the
    drafter's feed of a committed token) give the reference's logits; a
    done row writes only its scratch slot and keeps its logits."""
    jeng, teng = dense_pair
    ids, lens = _prompts(tok, ["Q:2+7=?A:", "Q:13+4=?A:", "Q:1=?"])
    js = jeng.prefill(jnp.asarray(ids), jnp.asarray(lens))
    ts = teng.prefill(torch.from_numpy(ids), torch.from_numpy(lens))
    assert ts.table is None and ts.cache["k"].shape == (2, 3, 32, 2, 16)
    want, got = [np.asarray(js.pending_logits)], [ts.pending_logits.numpy()]
    forced = np.array([[5, 9, 70], [33, 4, 8]], np.int32)
    for t in range(4):
        if t == 2:
            js = jeng.freeze_rows(js, [1])
            ts = teng.freeze_rows(ts, [1])
        js, _ = jeng.step(js, jax.random.key(0), JGREEDY)
        ts, _ = teng.step(ts, None, GREEDY)
        want.append(np.asarray(js.pending_logits))
        got.append(ts.pending_logits.numpy())
    for row in forced:
        js = jeng.forced_step(js, jnp.asarray(row))
        ts = teng.forced_step(ts, torch.from_numpy(row))
        want.append(np.asarray(js.pending_logits))
        got.append(ts.pending_logits.numpy())
    np.testing.assert_allclose(np.stack(got), np.stack(want), atol=ATOL)
    np.testing.assert_array_equal(ts.cache_len.numpy(), np.asarray(js.cache_len))
    np.testing.assert_allclose(ts.cache["k"].numpy(),
                               np.asarray(js.cache["k"]), atol=ATOL)


def test_dense_fork_reorder_generate_match_reference(dense_pair, tok):
    """Dense ``fork`` copies rows, ``reorder`` gathers them, ``generate``
    decodes through them, ``merge_rows`` scatters them into an empty
    state: greedy tokens equal the reference's, logprob sums within the
    f32 tolerance."""
    jeng, teng = dense_pair
    ids, lens = _prompts(tok, ["Q:5+6=?A:", "Q:8+1=?A:"])
    js = jeng.fork(jeng.prefill(jnp.asarray(ids), jnp.asarray(lens)), 2)
    ts = teng.fork(teng.prefill(torch.from_numpy(ids),
                                torch.from_numpy(lens)), 2)
    js, jt = jeng.generate(js, 5, jax.random.key(0), JGREEDY)
    ts, tt = teng.generate(ts, 5, None, GREEDY)
    idx = np.array([3, 0, 0, 2])
    js = jeng.reorder(js, jnp.asarray(idx))
    ts = teng.reorder(ts, idx)
    js2, jt2 = jeng.generate(js, 4, jax.random.key(0), JGREEDY)
    ts2, tt2 = teng.generate(ts, 4, None, GREEDY)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tt2.numpy(), np.asarray(jt2))
    np.testing.assert_allclose(ts2.logprob_sum.numpy(),
                               np.asarray(js2.logprob_sum), atol=1e-4)
    slots = teng.merge_rows(teng.empty_state(5), ts2, [4, 1, 0, 2])
    jslots = jeng.merge_rows(jeng.empty_state(5), js2,
                             jnp.asarray([4, 1, 0, 2], jnp.int32))
    slots = teng.release_rows(slots, [2])
    jslots = jeng.release_rows(jslots, [2])
    for name in ("cache_len", "done", "n_gen"):
        np.testing.assert_array_equal(getattr(slots, name).numpy(),
                                      np.asarray(getattr(jslots, name)))
    np.testing.assert_allclose(slots.cache["v"].numpy(),
                               np.asarray(jslots.cache["v"]), atol=ATOL)
