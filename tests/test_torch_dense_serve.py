"""Dense-row serving in the port against the JAX package, on the CPU: the
continuous scheduler over ``DecodeEngine(paged=False)`` and the direct
path, for Mamba2 (mamba2-130m-smoke), a small W4A16 zamba2-style hybrid
(``test_torch_mamba.w4_hybrid_cfgs``) and a transformer (qwen2.5-1.5b-
smoke on dense rows).

Greedy tokens must equal the JAX package's row for row: Best-of-4 groups
and plain requests through one slot pool (a later group admitted into
freed rows), one beam-search tree on the hybrid, and the direct path's
``run_method``.  Every prompt is padded to the scheduler's ``prompt_len``
and the SSM consumes the pads, in both packages alike.  Engine row
operations: done rows keep their conv / ssm states bit for bit across a
step and a forced step, ``merge_rows`` copies every cache leaf.  The
serve entry point runs the SSM families without ``--paged`` and refuses
the pool's options there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.core import best_of_n as JB
from repro.core import beam_search as JBS
from repro.core import controller as JC
from repro.core import reward as JRW
from repro.models import api as japi
from repro.quant.qlinear import quantize_model_params as jquantize
from repro.serving.engine import BeamSpec as JBeamSpec
from repro.serving.engine import ContinuousScheduler as JScheduler
from repro.serving.engine import DecodeEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.sampler import SamplerConfig as JSampler
from repro_torch import bridge
from repro_torch.configs import registry as R
from repro_torch.core import beam_search as BS
from repro_torch.core import best_of_n as B
from repro_torch.core import controller as C
from repro_torch.core import reward as RW
from repro_torch.data import tasks as T
from repro_torch.serving.engine import (BeamSpec, ContinuousScheduler,
                                        DecodeEngine, Request, SpecConfig)
from repro_torch.serving.sampler import SamplerConfig
from test_torch_mamba import w4_hybrid_cfgs

GREEDY, JGREEDY = SamplerConfig(greedy=True), JSampler(greedy=True)
MAX_LEN, PROMPT_LEN = 96, 16
ARCHS = ("mamba2-130m", "hybrid-w4", "qwen2.5-1.5b")


@pytest.fixture(scope="module")
def engines(tok):
    """arch -> (JAX dense engine, port dense engine) on the same weights
    (the W4A16 hybrid's quantized), built once per module."""
    made = {}

    def make(arch):
        if arch not in made:
            if arch == "hybrid-w4":
                jcfg, cfg = w4_hybrid_cfgs()
            else:
                jcfg, cfg = (JR.get_config(arch, smoke=True),
                             R.get_config(arch, smoke=True))
            jp = jax.jit(lambda k: japi.get_model(jcfg).init_params(
                k, jcfg))(jax.random.key(7))
            if arch == "hybrid-w4":
                jp = jax.jit(jquantize)(jp)
            tp = bridge.params_from_jax(jax.device_get(jp), device="cpu")
            kw = dict(max_len=MAX_LEN, eos_id=tok.eos_id, pad_id=tok.pad_id)
            made[arch] = (JEngine(jp, jcfg, **kw), DecodeEngine(tp, cfg, **kw))
        return made[arch]

    return make


def _prompt(tok, text, ref):
    ids = tok.encode(text)
    return jnp.asarray(ids) if ref else torch.tensor(ids, dtype=torch.int32)


def _schedule(engine, tok, *, ref, beam=False):
    """Two Best-of-4 groups and a plain request through 8 slots (the
    second group waits for the first's rows), or one beam tree (width 2 x
    expand 2, 2 boundaries of 6 tokens) beside a plain request."""
    sched_cls, req_cls, spec_cls = (JScheduler, JRequest, JBeamSpec) if ref \
        else (ContinuousScheduler, Request, BeamSpec)
    sched = sched_cls(engine, n_slots=8, prompt_len=PROMPT_LEN)
    tasks = T.gen_dataset(5, 2, max_terms=2)
    if beam:
        def score(token_lists, lp, ng):
            # a function of the tokens alone: greedy lanes that agree
            # tie exactly, and both packages break ties to the lowest lane
            return np.array([float(sum(t) % 97) for t in token_lists])

        sched.submit(req_cls(req_id=0, prompt=_prompt(tok, tasks[0].prompt,
                                                      ref),
                             search=spec_cls(
                                 width=2, expand=2, step_tokens=6,
                                 max_steps=2, score=score,
                                 step_stop_id=int(tok.encode(
                                     ".", bos=False)[0]))))
        sched.submit(req_cls(req_id=1, prompt=_prompt(tok, "Q:7+5=?A:", ref),
                             max_new_tokens=9))
    else:
        sched.submit(req_cls(req_id=0, prompt=_prompt(tok, tasks[0].prompt,
                                                      ref),
                             max_new_tokens=8, n_samples=4))
        sched.submit(req_cls(req_id=1, prompt=_prompt(tok, "Q:7+5=?A:", ref),
                             max_new_tokens=10))
        sched.submit(req_cls(req_id=2, prompt=_prompt(tok, tasks[1].prompt,
                                                      ref),
                             max_new_tokens=6, n_samples=4))
    res = sched.run(jax.random.key(0) if ref else None,
                    JGREEDY if ref else GREEDY)
    return sched, res


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_scheduler_best_of_n_matches_reference(engines, tok, arch):
    jeng, teng = engines(arch)
    jsched, want = _schedule(jeng, tok, ref=True)
    tsched, got = _schedule(teng, tok, ref=False)
    assert got == want
    s, ws = tsched.metrics.summary(), jsched.metrics.summary()
    for key in ("steps", "completed_requests", "completed_samples",
                "prefill_calls", "prefill_tokens", "decode_tokens",
                "preemptions", "peak_kv_bytes", "kv_quant"):
        assert s[key] == ws[key], key
    assert s["completed_requests"] == 3 and s["preemptions"] == 0
    assert max(r.admitted for r in tsched.metrics.records[1:]) == 1


def test_dense_scheduler_beam_matches_reference(engines, tok):
    jeng, teng = engines("hybrid-w4")
    jsched, want = _schedule(jeng, tok, ref=True, beam=True)
    tsched, got = _schedule(teng, tok, ref=False, beam=True)
    assert got == want
    assert tsched.beam_results == jsched.beam_results
    s, ws = tsched.metrics.summary(), jsched.metrics.summary()
    for key in ("steps", "beam_boundaries", "prm_batches", "decode_tokens"):
        assert s[key] == ws[key], key
    assert s["beam_boundaries"] == 2


DIRECT = {"best_of_n": dict(budget=3, max_tokens=8),
          "beam_search": dict(budget=4, max_tokens=8, beam_width=2,
                              beam_expand=2, beam_steps=2, step_tokens=6)}


@pytest.mark.parametrize("arch,method", [("mamba2-130m", "best_of_n"),
                                         ("hybrid-w4", "beam_search")])
def test_direct_run_method_matches_reference(monkeypatch, engines, tok,
                                             arch, method):
    """``run_method`` (the direct path: prefill, fork, generate): Best-of-3
    on mamba2 and beam search (2 x 2, 2 boundaries of 6 tokens) on the
    W4A16 hybrid, each method's default sampler made greedy on both
    sides, scored by the answer oracle (identical greedy samples tie
    exactly; a logprob score would rank them by their last bits)."""
    for fn in (JB.best_of_n, JBS.beam_search):
        monkeypatch.setitem(fn.__kwdefaults__, "sc", JGREEDY)
    for fn in (B.best_of_n, BS.beam_search):
        monkeypatch.setitem(fn.__kwdefaults__, "sc", GREEDY)
    jeng, teng = engines(arch)
    task = T.gen_dataset(9, 1, max_terms=2)[0]
    want = JC.run_method(jeng, tok, task,
                         JC.TTSSpec(method, **DIRECT[method]),
                         jax.random.key(0), JRW.OracleVerifier())
    got = C.run_method(teng, tok, task, C.TTSSpec(method, **DIRECT[method]),
                       None, RW.OracleVerifier())
    assert got.completions == want.completions
    assert (got.chosen, got.answer, got.decode_tokens) == \
        (want.chosen, want.answer, want.decode_tokens)
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))


def test_done_rows_keep_recurrent_state_bit_for_bit(engines, tok):
    """A frozen (done) row's conv and ssm states, and its pending logits,
    come out of a decode step and a forced step unchanged to the bit,
    while live rows advance (the scheduler tests hold the live rows'
    tokens to the reference's)."""
    _, teng = engines("hybrid-w4")
    ids, lens = tok.encode_batch(["Q:1+2=?A:", "Q:30+4=?A:", "Q:5+6=?"], 12)
    st = teng.freeze_rows(teng.prefill(torch.from_numpy(ids),
                                       torch.from_numpy(lens)), [1])
    before = {k: v.clone() for k, v in st.cache.items()}
    pending = st.pending_logits.clone()
    st, _ = teng.step(st, None, GREEDY)
    for name in ("conv", "ssm"):
        assert torch.equal(st.cache[name][:, 1], before[name][:, 1]), name
        assert not torch.equal(st.cache[name][:, 0], before[name][:, 0])
    assert torch.equal(st.pending_logits[1], pending[1])
    before = {k: v.clone() for k, v in st.cache.items()}
    st = teng.forced_step(st, torch.tensor([5, 6, 7], dtype=torch.int32))
    for name in ("conv", "ssm"):
        assert torch.equal(st.cache[name][:, 1], before[name][:, 1]), name
        assert not torch.equal(st.cache[name][:, 2], before[name][:, 2])


def test_merge_rows_copies_every_leaf(engines, tok):
    """``merge_rows`` scatters a 2-row prefill into rows 3 and 1 of an
    empty 4-row state, for every cache leaf (conv, ssm, the shared
    block's K/V); rows 0 and 2 stay empty."""
    _, teng = engines("hybrid-w4")
    ids, lens = tok.encode_batch(["Q:11+2=?A:", "Q:3+40=?A:"], 12)
    src = teng.prefill(torch.from_numpy(ids), torch.from_numpy(lens))
    dst = teng.merge_rows(teng.empty_state(4), src, [3, 1])
    assert set(dst.cache) == {"conv", "ssm", "attn_k", "attn_v"}
    for name, leaf in dst.cache.items():
        assert torch.equal(leaf[:, [3, 1]], src.cache[name]), name
        assert not leaf[:, [0, 2]].any(), name
    np.testing.assert_array_equal(dst.done.numpy(), [True, False, True,
                                                     False])


def test_dense_engines_refuse_pool_operations(engines):
    """The SSM families have no paged layout; a dense scheduler refuses
    the prefix cache and speculation with the reference's messages."""
    from repro_torch.serving.kv_pool import KVPool
    from repro_torch.serving.prefix_cache import PrefixCache

    _, teng = engines("mamba2-130m")
    with pytest.raises(ValueError, match="transformer family only"):
        DecodeEngine(teng.params, teng.cfg, paged=True, max_len=MAX_LEN)
    qcfg = R.get_config("qwen2.5-1.5b", smoke=True)
    with pytest.raises(ValueError, match="prefix_cache requires a paged"):
        ContinuousScheduler(teng, prefix_cache=PrefixCache(
            KVPool(qcfg, 4, 8, device="cpu")))
    with pytest.raises(ValueError, match="speculative decoding requires"):
        ContinuousScheduler(teng, spec=SpecConfig(k=4, self_draft=True))


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_cpu_serve_runs_the_ssm_families_on_dense_rows(arch, capsys):
    """``serve.py`` without ``--paged``: the direct path completes (the
    continuous path: ``test_torch_configs``); the pool's options are
    refused, and so is ``--quantize`` where ``in_proj`` does not tile
    (both smoke configs; mamba2-130m at full width too, in both
    packages)."""
    from repro_torch.launch import serve

    base = ["--arch", arch, "--smoke", "--device", "cpu", "--dry"]
    rows = serve.main(base + ["--method", "beam_search"])
    assert rows[0]["method"] == "beam_search" and "serving" not in rows[0]
    out = capsys.readouterr().out
    assert "kv=dense" in out and "kv pool clean" not in out
    for extra, word in ((["--kv-quant", "q8"], "--kv-quant requires"),
                        (["--continuous", "--prefix-cache"],
                         "--prefix-cache requires"),
                        (["--continuous", "--spec-k", "4"],
                         "--spec-k requires")):
        with pytest.raises(SystemExit, match=word):
            serve.main(base + extra)
    with pytest.raises(ValueError, match="transformer family only"):
        serve.main(base + ["--paged"])
    with pytest.raises(ValueError, match="tile scheme"):
        serve.main(base + ["--quantize"])
