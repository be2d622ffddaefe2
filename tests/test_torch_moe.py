"""The port's mixture-of-experts FFN and MoE serving against the JAX
package, on the same weights (the JAX init carried across by
``repro_torch.bridge``) and inputs from numpy seeds.

``moe_ffn`` (fp and quantized experts) must give the reference's output,
aux loss, routing ids (ties broken toward the lower expert id, as
``jax.lax.top_k``) and drop pattern, at a call that drops picks past an
expert's capacity and at one that cannot; quantize / dequantize of a
stacked (L, E, K, N) expert leaf must be byte-equal.  End to end, the
continuous Best-of-N greedy tokens of olmoe-smoke and mixtral-smoke
(sliding window) equal the JAX scheduler's on fp and Q8 pools, as do
the other methods' rows through ``sweep`` (scheduler beam search, direct
self-consistency), a
prefix-cache hit's partial-prefill logits equal the reference's hit (a
hit legitimately differs from a miss: capacity depends on the call's
token count), the prefix-cache scheduler gives the reference's tokens,
and speculative greedy tokens equal the reference's speculative tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.core import controller as JC
from repro.core.reward import OracleVerifier as JOracle
from repro.models import api as japi
from repro.models import moe as JM
from repro.quant.qlinear import dequantize_model_params as jax_dequantize
from repro.quant.qlinear import quantize_model_params as jax_quantize
from repro.serving.engine import ContinuousScheduler as JScheduler
from repro.serving.engine import DecodeEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.engine import SpecConfig as JSpecConfig
from repro.serving.prefix_cache import PrefixCache as JPrefixCache
from repro.serving.sampler import SamplerConfig as JSampler
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.core import controller as C
from repro_torch.core.reward import OracleVerifier
from repro_torch.data import tasks as T
from repro_torch.models import moe as M
from repro_torch.quant.qlinear import (dequantize_model_params,
                                       quantize_model_params)
from repro_torch.serving.engine import (ContinuousScheduler, DecodeEngine,
                                        Request, SpecConfig)
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.sampler import SamplerConfig

# f32 on both sides, summed in other orders (~1e-6 here): the FFN output
# and the engines' logits are held to 1e-5 absolute plus 1e-5 relative
# (the skewed FFN inputs reach |y| ~ 30, a few f32 ulps there); routing,
# drops and greedy tokens exactly
ATOL, RTOL = 1e-5, 1e-5
ARCHS = ("olmoe-1b-7b", "mixtral-8x7b")


@pytest.fixture(scope="module")
def olmoe():
    cfg = jax_get_config("olmoe-1b-7b", smoke=True)
    p = JM.init_moe(jax.random.key(0), cfg, jnp.float32)
    return cfg, get_config("olmoe-1b-7b", smoke=True), p


def _tree(p):
    return bridge._convert(jax.device_get(p), "cpu")


def _tokens(cfg, T, skew, seed):
    """(1, T, d) f32 activations; ``skew`` adds one shared direction to
    every token, so routing piles onto a few experts and picks drop."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, T, cfg.d_model)).astype(np.float32)
    return x + skew * rng.standard_normal(cfg.d_model).astype(np.float32)


def _reference_kept(p, x, cfg):
    """The reference's own drop pattern: (T, k) bool, pick (t, j) kept.
    ``_dispatch_compute_combine`` with weights one-hot on column j gives
    token t a non-zero output iff its j-th pick found a slot (an unfilled
    slot is a zero row, and SiLU(0) = 0)."""
    T = x.shape[1]
    xf = jnp.asarray(x.reshape(T, cfg.d_model))
    _, ids, _ = JM._route(xf @ p["router"]["w"], cfg.moe)
    k = cfg.moe.top_k
    kept = []
    for j in range(k):
        w = jnp.zeros((T, k)).at[:, j].set(1.0)
        y = JM._dispatch_compute_combine(xf, w, ids, p["experts"], cfg.moe,
                                         None)
        kept.append(np.asarray(jnp.abs(y).max(axis=-1) > 0))
    return np.stack(kept, axis=1), np.asarray(ids)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("T,skew,drops", [(8, 0.0, False), (64, 4.0, True)])
def test_moe_ffn_matches_reference(olmoe, quant, T, skew, drops):
    """y, aux, routing ids and the drop pattern; T = 8 cannot drop (C = 8
    and a token takes an expert at most once), T = 64 with skewed routing
    must (C = 20 of 128 picks over 8 experts)."""
    cfg, tcfg, p = olmoe
    if quant:
        p = jax_quantize(p)
    tp = _tree(p)
    x = _tokens(cfg, T, skew, seed=T)
    jy, jaux = JM.moe_ffn(p, jnp.asarray(x), cfg)
    ty, taux = M.moe_ffn(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)

    pf = jax_dequantize(p) if quant else p
    kept, ids = _reference_kept(pf, x, cfg)
    xf = torch.from_numpy(x.reshape(T, -1))
    _, tids, _ = M.route(xf @ tp["router"]["w"], tcfg.moe)
    token_slot, C = M.dispatch_slots(tids, tcfg.moe)
    assert C == M.capacity(T, tcfg.moe) == (20 if T == 64 else 8)
    np.testing.assert_array_equal(tids.numpy(), ids)
    tkept = (token_slot < tcfg.moe.n_experts * C).numpy().reshape(T, -1)
    np.testing.assert_array_equal(tkept, kept)
    assert (not kept.all()) == drops


def test_route_breaks_ties_toward_the_lower_expert_id(olmoe):
    """Rows of exactly equal router logits: the same ids and weights as
    ``jax.lax.top_k``, including a row of all-equal logits."""
    cfg, tcfg, _ = olmoe
    E = cfg.moe.n_experts
    rows = np.array([[0, 2, 2, 1, 2, 0, -1, 2],
                     [1, 1, 1, 1, 1, 1, 1, 1],
                     [3, 0, 0, 3, 0, 0, 0, 0],
                     [-2, 5, -2, 5, -2, 5, -2, 0.5]], np.float32)
    assert rows.shape[1] == E
    jw, jids, jaux = JM._route(jnp.asarray(rows), cfg.moe)
    tw, tids, taux = M.route(torch.from_numpy(rows), tcfg.moe)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tids[:, 0].numpy(), [1, 0, 0, 1])
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def test_stacked_expert_quantization_is_byte_equal(olmoe):
    """quantize / dequantize of (L, E, K, N) and (E, K, N) expert stacks:
    codes, scales and the per-expert codebook (broadcast over the stacked
    dims, as the reference's vmap does) byte for byte, dequantized f32
    bit for bit."""
    rng = np.random.default_rng(3)
    w4 = rng.standard_normal((2, 3, 64, 32)).astype(np.float32)
    w3 = rng.standard_normal((3, 32, 64)).astype(np.float32)
    tree = {"layers": {"moe": {"experts": {"gate": w4, "down": w3}}}}
    jq = jax.device_get(jax_quantize(jax.tree.map(jnp.asarray, tree)))
    tq = quantize_model_params(jax.tree.map(torch.from_numpy, tree))
    for name in ("gate", "down"):
        want, got = jq["layers"]["moe"]["experts"][name], \
            tq["layers"]["moe"]["experts"][name]
        assert sorted(want) == sorted(got)
        for leaf in want:
            a, b = np.asarray(want[leaf]), got[leaf].numpy()
            assert a.shape == b.shape and a.dtype == b.dtype, leaf
            assert a.tobytes() == b.tobytes(), (name, leaf)
    assert tq["layers"]["moe"]["experts"]["gate"]["codebook"].shape == \
        (2, 3, 16)
    jd = jax.device_get(jax_dequantize(jq))
    td = dequantize_model_params(tq)
    for name in ("gate", "down"):
        a = np.asarray(jd["layers"]["moe"]["experts"][name])
        b = td["layers"]["moe"]["experts"][name].numpy()
        assert b.dtype == np.float32 and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# end to end: the engines and the scheduler
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    """arch -> (jax cfg, port cfg, jax params, port params), seed 7."""
    out = {}
    for arch in ARCHS:
        cfg = jax_get_config(arch, smoke=True)
        jp = japi.get_model(cfg).init_params(jax.random.key(7), cfg)
        out[arch] = (cfg, get_config(arch, smoke=True), jp,
                     bridge.params_from_jax(jax.device_get(jp), device="cpu"))
    return out


def _capture(monkeypatch, module):
    made = []
    base = module.ContinuousScheduler

    class Capturing(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(module, "ContinuousScheduler", Capturing)
    return made


def _samples(sched):
    return {(i, s.sample_idx): list(s.tokens)
            for i, smps in sched.completed.items() for s in smps}


def _engines(models, arch, kv, max_len=64, n_blocks=64):
    cfg, tcfg, jp, tp = models[arch]
    kw = dict(max_len=max_len, eos_id=2, pad_id=0, paged=True, block_size=8,
              n_blocks=n_blocks, kv_quant=kv)
    return JEngine(jp, cfg, **kw), DecodeEngine(tp, tcfg, **kw)


@pytest.mark.parametrize("kv", ["none", "q8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_best_of_n_matches_reference(monkeypatch, tok, models,
                                                arch, kv):
    """Best-of-3 over 2 tasks on 4 slots, greedy: identical samples and
    serving counts, and the pool drains."""
    tasks = T.gen_dataset(123, 2)
    jeng, teng = _engines(models, arch, kv)
    j_made, t_made = _capture(monkeypatch, JC), _capture(monkeypatch, C)
    want = JC.serve_best_of_n(jeng, tok, tasks, n=3, max_tokens=8,
                              rng=jax.random.key(0), scorer=JOracle(),
                              n_slots=4, sc=JSampler(greedy=True))
    got = C.serve_best_of_n(teng, tok, tasks, n=3, max_tokens=8,
                            rng=torch.Generator().manual_seed(0),
                            scorer=OracleVerifier(), n_slots=4,
                            sc=SamplerConfig(greedy=True))
    assert _samples(t_made[-1]) == _samples(j_made[-1])
    for key in ("steps", "decode_tokens", "prefill_tokens",
                "completed_samples", "peak_kv_bytes"):
        assert got["serving"][key] == want["serving"][key], key
    assert teng.pool.blocks_in_use == 0


@pytest.mark.parametrize("kv", ["none", "q8"])
def test_cache_hit_partial_prefill_matches_reference_hit(models, kv):
    """A ragged batch of two cache hits (cached lengths 16 and 11) over
    34-token prompts: the suffix-only partial prefill's logits equal the
    reference's hit, and the miss (one full prefill) the reference's
    miss.  The suffixes route 2 x 23 tokens through capacity 12, the
    full prompts 2 x 34 through capacity 17."""
    jeng, teng = _engines(models, "olmoe-1b-7b", kv)
    rng = np.random.default_rng(0)
    prompts = rng.integers(3, 300, (2, 34)).astype(np.int32)
    clens = [16, 11]
    outs = []
    for eng, ref in ((jeng, True), (teng, False)):
        arr = jnp.asarray if ref else torch.from_numpy
        full = eng.prefill(arr(prompts))
        table = np.asarray(jax.device_get(full.cache["table"])) if ref \
            else full.table
        ctab = np.zeros((2, eng.table_width), np.int32)
        suffix = np.zeros((2, 34 - min(clens)), np.int32)
        for i, c in enumerate(clens):
            n = -(-c // 8)
            ctab[i, :n] = table[i, :n]
            eng.pool.retain(table[i, :n])
            suffix[i, :34 - c] = prompts[i, c:]
        lens = np.array([34 - c for c in clens], np.int32)
        hit = eng.prefill(arr(suffix), arr(lens), cached_table=ctab,
                          cached_lens=np.array(clens))
        outs.append([np.asarray(full.pending_logits),
                     np.asarray(hit.pending_logits)])
    (jmiss, jhit), (tmiss, thit) = outs
    np.testing.assert_allclose(tmiss, jmiss, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(thit, jhit, atol=ATOL, rtol=RTOL)
    assert np.abs(jhit - jmiss).max() > 1e-3  # capacity differs


def test_prefix_cache_scheduler_matches_reference(tok, models):
    """Best-of-2 over 3 tasks sharing a 3-shot header (80-token prompts:
    each prefill drops picks), Q8 pool, with the prefix cache: the same
    samples, hits and saved tokens as the JAX scheduler."""
    tasks = T.shared_prefix_dataset(123, 3, n_shots=3)
    jeng, teng = _engines(models, "olmoe-1b-7b", "q8", max_len=128,
                          n_blocks=96)
    scheds = []
    for eng, ref in ((jeng, True), (teng, False)):
        cache = (JPrefixCache if ref else PrefixCache)(eng.pool)
        prompts = [tok.encode(t.prompt) for t in tasks]
        sched = (JScheduler if ref else ContinuousScheduler)(
            eng, n_slots=4, prompt_len=max(map(len, prompts)),
            prefix_cache=cache)
        for i, ids in enumerate(prompts):
            sched.submit((JRequest if ref else Request)(
                req_id=i, prompt=(jnp.asarray(ids) if ref else
                                  torch.tensor(ids, dtype=torch.int32)),
                max_new_tokens=8, n_samples=2))
        if ref:
            sched.run(jax.random.key(0), JSampler(greedy=True))
        else:
            sched.run(torch.Generator().manual_seed(0),
                      SamplerConfig(greedy=True))
        scheds.append(sched)
    (js, ts) = scheds
    assert _samples(ts) == _samples(js)
    jm, tm = js.metrics.summary(), ts.metrics.summary()
    assert tm["prefix_cache_hits"] == jm["prefix_cache_hits"] >= 1
    assert tm["prefill_tokens_saved"] == jm["prefill_tokens_saved"]
    assert ts.engine.pool.blocks_in_use == ts.cache.stats()["cached_blocks"]


@pytest.mark.parametrize("mode", ["self", "draft"])
def test_speculative_tokens_match_reference_spec(tok, models, mode):
    """k = 4 speculative greedy rounds (verify at T = slots x W: picks
    drop) give the reference's speculative tokens and per-round accepted
    counts, self-drafted or drafted by the registry's dense model."""
    jeng, teng = _engines(models, "olmoe-1b-7b", "none")
    reqs = [("Q:2+7=?A:", 12), ("Q:1+1=?A:", 6), ("Q:9+9=?A:", 10)]
    if mode == "self":
        specs = (JSpecConfig(k=4, self_draft=True),
                 SpecConfig(k=4, self_draft=True))
    else:
        specs = (JSpecConfig(k=4, draft_model="qwen2.5-1.5b"),
                 SpecConfig(k=4, draft_model="qwen2.5-1.5b"))
    out = []
    for eng, ref, spec in ((jeng, True, specs[0]), (teng, False, specs[1])):
        rounds = []
        verify = eng.spec_verify

        def recording(*a, _v=verify, _r=rounds, **kw):
            st, commit = _v(*a, **kw)
            _r.append(np.asarray(commit).sum(axis=1).tolist())
            return st, commit

        mp = pytest.MonkeyPatch()
        mp.setattr(eng, "spec_verify", recording)
        try:
            sched = (JScheduler if ref else ContinuousScheduler)(
                eng, n_slots=3, prompt_len=16, stop_ids=(9999,), spec=spec)
            if not ref and mode == "draft":
                sched._draft.params = bridge.params_from_jax(
                    jax.device_get(out[0][2]._draft.params), device="cpu")
            for i, (text, n) in enumerate(reqs):
                ids = tok.encode(text)
                sched.submit((JRequest if ref else Request)(
                    req_id=i, prompt=(jnp.asarray(ids) if ref else
                                      torch.tensor(ids, dtype=torch.int32)),
                    max_new_tokens=n))
            if ref:
                sched.run(jax.random.key(0), JSampler(greedy=True))
            else:
                sched.run(torch.Generator().manual_seed(0),
                          SamplerConfig(greedy=True))
        finally:
            mp.undo()
        assert eng.pool.blocks_in_use == 0
        out.append((_samples(sched), rounds, sched))
    (jt, jr, _), (tt, tr, _) = out
    assert tt == jt
    assert tr == jr and len(tr) > 0


def test_bridge_carries_moe_and_patch_leaves_byte_for_byte():
    """A W4A16 olmoe-smoke tree: router and per-layer expert stacks (Q4
    gate/up with their (E, 16) codebooks, Q8 down) split from (L, E, ...)
    byte for byte; internvl2-smoke's ``patch_proj`` likewise."""
    cfg = jax_get_config("olmoe-1b-7b", smoke=True)
    host = jax.device_get(jax_quantize(japi.get_model(cfg).init_params(
        jax.random.key(1), cfg)))
    tp = bridge.params_from_jax(host, device="cpu")
    leaves = [("router", "w", None)] + [
        ("experts", name, leaf) for name, leaves in (
            ("gate", ("codes", "scales", "codebook")),
            ("up", ("codes", "scales", "codebook")),
            ("down", ("codes", "scales"))) for leaf in leaves]
    for i in range(cfg.n_layers):
        for grp, name, leaf in leaves:
            a = host["layers"]["moe"][grp][name]
            b = tp["layers"][i]["moe"][grp][name]
            a, b = (a, b) if leaf is None else (a[leaf], b[leaf])
            a, b = np.asarray(a)[i], b.numpy()
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert tp["layers"][0]["moe"]["experts"]["gate"]["codebook"].shape == \
        (cfg.moe.n_experts, 16)
    vcfg = jax_get_config("internvl2-1b", smoke=True)
    vhost = jax.device_get(japi.get_model(vcfg).init_params(
        jax.random.key(2), vcfg))
    got = bridge.params_from_jax(vhost, device="cpu")["patch_proj"]["w"]
    assert got.numpy().tobytes() == np.asarray(
        vhost["patch_proj"]["w"]).tobytes()


def test_sweep_of_every_method_matches_reference(monkeypatch, tok, models):
    """olmoe-smoke through ``sweep(continuous=True)`` on a Q8 pool:
    Best-of-N and PRM beam search through the scheduler, self-consistency
    on the direct path (one prefill, fork, ``generate``); every row equals
    the reference's.  Direct rows sample with their method's default sampler,
    made greedy on both sides alike (``tests/test_torch_tts.py``)."""
    from repro.core import beam_search as JBS
    from repro.core import best_of_n as JB
    from repro.core import self_consistency as JSC
    from repro_torch.core import beam_search as BS
    from repro_torch.core import best_of_n as B
    from repro_torch.core import self_consistency as SC

    for fn in (JB.best_of_n, JSC.self_consistency, JBS.beam_search):
        monkeypatch.setitem(fn.__kwdefaults__, "sc", JSampler(greedy=True))
    for fn in (B.best_of_n, SC.self_consistency, BS.beam_search):
        monkeypatch.setitem(fn.__kwdefaults__, "sc",
                            SamplerConfig(greedy=True))
    jeng, teng = _engines(models, "olmoe-1b-7b", "q8")
    tasks = T.gen_dataset(31, 2, max_terms=2)
    specs = [("best_of_n", 3, {}), ("self_consistency", 3, {}),
             ("beam_search", 4, dict(beam_width=2, beam_expand=2,
                                     beam_steps=2, step_tokens=6))]
    want = JC.sweep(jeng, tok, tasks,
                    [JC.TTSSpec(m, b, max_tokens=8, **kw)
                     for m, b, kw in specs],
                    jax.random.key(0), JOracle(), continuous=True,
                    n_slots=4, sc=JSampler(greedy=True))
    got = C.sweep(teng, tok, tasks,
                  [C.TTSSpec(m, b, max_tokens=8, **kw) for m, b, kw in specs],
                  None, OracleVerifier(), continuous=True, n_slots=4,
                  sc=SamplerConfig(greedy=True))
    assert teng.pool.blocks_in_use == 0
    assert [("serving" in g) for g in got] == [True, False, True]
    for w, g in zip(want, got):
        for key in ("method", "budget", "accuracy", "decode_tokens"):
            assert g[key] == w[key], (g["method"], key)
        assert ("serving" in g) == ("serving" in w)
        if "serving" in g:
            for key in ("steps", "completed_samples", "beam_boundaries",
                        "peak_kv_bytes"):
                assert g["serving"][key] == w["serving"][key], key
