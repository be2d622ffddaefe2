"""The port's kernel profiler and numerics canary against the JAX
package's.

Unit behaviour of ``KernelProfiler`` (the every-Nth-step schedules, eager
phase accounting and wall attribution, sampling, untimed ops, canary
warnings, hook install/uninstall, the report validator, write and CLI);
the cost models of ``kernels/autotune`` (the JAX package's FLOPs at the
served shapes, and bytes equal to the bytes ``chip_smoke.py`` bounds its
kernel rows with); the ``"plain"`` paged attention against the JAX
package's ``"xla"`` branch; then the profiler on the port's scheduler,
from random ``tiny_cfg`` weights quantized W4A16 by the JAX package and
carried across by the bridge: each phase's op calls equal the kernels'
launch counters (the plain versions stand in for the kernels on the CPU
and are counted as the kernels count their launches), the report passes
both packages' validators, a profiler with canary 0.5 leaves tokens and
pool bytes bit-identical, and a canary on every greedy Q8 step finds no
drift."""
import importlib.util
import itertools
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import autotune as JA
from repro.models import api as japi
from repro.models import layers as JL
from repro.quant.qlinear import quantize_model_params as jax_quantize
from repro.serving import kv_quant as JKQ
from repro.serving import profiling as JP
from repro_torch import bridge
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import autotune as A
from repro_torch.kernels import lut_dequant_gemm as G
from repro_torch.kernels import lut_dequant_kv as LK
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as PA
from repro_torch.models import layers as L
from repro_torch.quant import tile_quant as TQ
from repro_torch.serving.engine import (ContinuousScheduler, DecodeEngine,
                                        Request, SpecConfig)
from repro_torch.serving.kv_quant import kv_tile_geometry, quantize_kv
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.profiling import (NULL_PROFILE_METRICS, SCHEMA,
                                           KernelProfiler, _interval, main,
                                           validate_profile_report)
from repro_torch.serving.sampler import SamplerConfig

ROOT = Path(__file__).resolve().parents[1]
NO_STOP = (9999,)
GREEDY = SamplerConfig(greedy=True)
PROMPT_LEN = 40
# the canary on the CPU compares the production path's plain versions
# (kernels/ref.py: the paged kernels' online-softmax recurrence) with the
# "plain" impl (gather, dequant, f32 softmax): two f32 orderings of the
# same attention over the same Q8 codes
CANARY_ATOL = 1e-4


def _counting_clock(tick_s=1e-3):
    c = itertools.count()
    return lambda: next(c) * tick_s


def _torch_cfg(cfg):
    return ModelConfig(**{f: getattr(cfg, f) for f in (
        "name", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
        "vocab_size", "dtype", "param_dtype")})


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def qweights(tiny_cfg):
    """W4A16 tiny_cfg weights (JAX init, JAX quantizer), bridged."""
    jp = jax_quantize(japi.get_model(tiny_cfg).init_params(
        jax.random.key(11), tiny_cfg))
    return bridge.params_from_jax(jax.device_get(jp), device="cpu")


# ---------------------------------------------------------------------------
# KernelProfiler unit behaviour (no scheduler)
# ---------------------------------------------------------------------------


def _one_step(prof, ops_=(("flash_attention", 1e6, 1e3),)):
    prof.begin_step()
    t0 = prof.phase_begin("decode")
    for op in ops_:
        prof.record_op(*op)
    prof.phase_end("decode", t0, outputs=torch.zeros(()))
    prof.end_step(1.0)


@pytest.mark.parametrize("case", [
    "interval", "phase_accounting", "sampling", "untimed",
    "canary_warnings", "install_uninstall", "validator", "write_and_cli",
    "refuses_invalid"])
def test_profiler_unit(case, tmp_path, capsys, monkeypatch):
    if case == "interval":
        for rate in (0.0, -1.0, 1.0, 0.25, 1.0 / 3.0, 5.0, 0.5):
            assert _interval(rate) == JP._interval(rate)
        assert (_interval(0.0), _interval(0.25), _interval(5.0)) == (0, 4, 1)
    elif case == "phase_accounting":
        # eager: every call's ops fire inside its phase and count once;
        # nothing replays into a later call of the same phase
        prof = KernelProfiler(sample_rate=1.0, clock=_counting_clock())
        _one_step(prof, (("flash_attention", 1e6, 1e3),
                         ("lut_dequant_matmul", 2e6, 4e6)))
        _one_step(prof, ())
        rep = prof.report()
        assert rep["kernels"]["flash_attention"]["calls"] == 1
        assert rep["kernels"]["lut_dequant_matmul"]["calls"] == 1
        assert rep["phases"]["decode"]["calls"] == 2
        assert rep["phases"]["decode"]["sampled"] == 2
        b1 = A.roofline_bound_s(1e6, 1e3)
        b2 = A.roofline_bound_s(2e6, 4e6)
        assert rep["phases"]["decode"]["bound_s"] == pytest.approx(b1 + b2)
        # the first step's wall splits across its two ops by bound share
        w = rep["kernels"]["flash_attention"]["wall_s"] + \
            rep["kernels"]["lut_dequant_matmul"]["wall_s"]
        assert rep["kernels"]["flash_attention"]["wall_s"] == \
            pytest.approx(w * b1 / (b1 + b2))
        assert set(rep["breakdown"]) == {"softmax", "dequant"}
        assert validate_profile_report(rep) == []
        assert JP.validate_profile_report(rep) == []
    elif case == "sampling":
        prof = KernelProfiler(sample_rate=0.5, clock=_counting_clock())
        for _ in range(4):
            _one_step(prof)
        rep = prof.report()
        assert rep["steps"] == 4 and rep["sampled_steps"] == 2
        assert rep["phases"]["decode"]["sampled"] == 2
        assert rep["kernels"]["flash_attention"]["calls"] == 4
        assert prof.summary_metrics()["profiled_steps"] == 2
    elif case == "untimed":
        prof = KernelProfiler(clock=_counting_clock())
        prof.record_op("tile_quantize", 1e6, 1e3)
        rep = prof.report()
        assert rep["kernels"]["tile_quantize"]["calls"] == 1
        assert rep["phases"]["untimed"]["bound_s"] > 0
        assert validate_profile_report(rep) == []
    elif case == "canary_warnings":
        prof = KernelProfiler(canary_rate=1.0, clock=_counting_clock())
        prof.record_canary(max_logit_err=0.2, flips=3, rows=4,
                           kv_err_per_layer=[0.1, 0.5])
        assert any("logit error" in w for w in prof.warnings)
        assert any("flip rate" in w for w in prof.warnings)
        assert any("round-trip" in w for w in prof.warnings)
        s = prof.summary_metrics()
        assert s["canary_max_logit_err"] == pytest.approx(0.2)
        assert s["canary_argmax_flip_rate"] == pytest.approx(0.75)
        assert s["canary_kv_roundtrip_err"] == pytest.approx(0.5)
        assert set(s) == set(NULL_PROFILE_METRICS) == \
            set(JP.NULL_PROFILE_METRICS)
        assert prof.report()["canary"]["warnings"] == prof.warnings
    elif case == "install_uninstall":
        seen = []
        prev = ops.set_op_hook(lambda *a: seen.append(a))
        try:
            prof = KernelProfiler()
            prof.install()
            ops.record_op("flash_attention", 1.0, 1.0)
            assert prof._ops and not seen  # the profiler intercepts
            prof.uninstall()
            ops.record_op("flash_attention", 1.0, 1.0)
            assert len(seen) == 1          # the previous hook is back
        finally:
            ops.set_op_hook(prev)
        assert ops.op_hook() is prev
    elif case == "validator":
        assert validate_profile_report([]) != []
        assert any("schema" in b for b in validate_profile_report({}))
        rep = KernelProfiler(clock=_counting_clock()).report()
        assert validate_profile_report(rep) == [] and rep["schema"] == SCHEMA
        bads = []
        bad = dict(rep)
        del bad["canary"]
        bads.append((bad, "missing top-level"))
        for path, value, msg in (
                (("kernels", "x"), {"calls": 1}, "kernel x"),
                (("breakdown",), {"softmax": 0.9, "dequant": 0.9}, "sum"),
                (("summary", "kernel_time_share"), "high",
                 "kernel_time_share"),
                (("canary", "kv_roundtrip_err_per_layer"), ["broken"],
                 "kv_roundtrip")):
            bad = json.loads(json.dumps(rep))
            node = bad
            for key in path[:-1]:
                node = node[key]
            node[path[-1]] = value
            bads.append((bad, msg))
        for bad, msg in bads:
            got = validate_profile_report(bad)
            assert any(msg in b for b in got)
            assert got == JP.validate_profile_report(bad)
    elif case == "write_and_cli":
        prof = KernelProfiler(clock=_counting_clock())
        _one_step(prof)
        path = str(tmp_path / "profile.json")
        prof.write_report(path)
        assert JP.validate_profile_report(json.load(open(path))) == []
        assert main([path]) == 0 and JP.main([path]) == 0
        assert "OK" in capsys.readouterr().out
        bad = str(tmp_path / "bad.json")
        json.dump({"schema": "nope"}, open(bad, "w"))
        assert main([bad]) == 1
        assert main([str(tmp_path / "missing.json")]) == 1
        assert main([]) == 2
    else:
        prof = KernelProfiler(clock=_counting_clock())
        monkeypatch.setattr(prof, "report", lambda: {"schema": "wrong"})
        with pytest.raises(ValueError, match="refusing"):
            prof.write_report(str(tmp_path / "never.json"))
        assert not (tmp_path / "never.json").exists()


# ---------------------------------------------------------------------------
# Cost models: the JAX package's FLOPs, chip_smoke.py's bytes
# ---------------------------------------------------------------------------

# qwen2.5-1.5b's Q4 projections (K, N) and the M the serve launches K3 at
# (8 decode slots, 14 the padded Best-of-N prompt, 32 a k = 4 verify)
GEMM_KN = ((1536, 1536), (1536, 256), (1536, 8960))


def _recorded(fn, *args, **kw):
    seen = []
    prev = ops.set_op_hook(lambda *a: seen.append(a))
    try:
        fn(*args, **kw)
    finally:
        ops.set_op_hook(prev)
    assert len(seen) == 1
    return seen[0]


def test_cost_models_match_reference_flops_and_chip_smoke_bytes():
    cs = _chip_smoke()
    # K3: one decode-step projection at M 8, (1536, 1536): 1,376,320 B
    # (bf16 x and out, packed codes, f16 tile scales, the codebook)
    flops, nbytes = A.gemm_cost(8, 1536, 1536)
    assert nbytes == 8 * 1536 * 2 * 2 + 1536 * 768 + 768 * 96 * 2 + 64 \
        == 1376320
    assert A.roofline_bound_s(flops, nbytes) * 1e3 == pytest.approx(
        0.000411, abs=5e-7)
    gen = torch.Generator().manual_seed(0)
    for M in (8, 14, 32):
        for K, N in GEMM_KN:
            assert A.gemm_cost(M, K, N)[0] == JA.gemm_cost(M, K, N)[0]
        qw = TQ.quantize(torch.randn((1536, 256), generator=gen),
                         scheme="tile")
        x = torch.randn((M, 1536), generator=gen).to(torch.bfloat16)
        name, fl, nb = _recorded(ops.lut_dequant_matmul, x, qw)
        assert name == "lut_dequant_matmul"
        assert (nb, fl) == cs.gemm_bytes_flops(x, qw) == \
            A.gemm_cost(M, 1536, 256)[::-1]
    # K1/K2 at the decode shape: 8 rows, 12 query heads over 2 KV heads,
    # head_dim 128, 16 blocks of 16 tokens; every slot live, so the
    # hook's table-width count and chip_smoke's live count agree
    B, Hkv, G_, D, bs, W = 8, 2, 6, 128, 16, 16
    gr, gc = kv_tile_geometry(Hkv, D)
    for kind in ("fp", "q8", "q4"):
        fp = torch.randn((1 + B * W, bs, Hkv, D), generator=gen)
        pool = fp.to(torch.bfloat16) if kind == "fp" else \
            quantize_kv(fp, mode=kind, gr=gr, gc=gc)
        q = torch.randn((B, 1, Hkv * G_, D), generator=gen).to(torch.bfloat16)
        table = torch.arange(1, 1 + B * W, dtype=torch.int32).reshape(B, W)
        lens = torch.full((B,), W * bs, dtype=torch.int32)
        name, fl, nb = _recorded(ops.paged_flash_decode, q, pool, pool,
                                 table, lens)
        assert name == "paged_flash_decode"
        slab = ops.pool_slab_bytes(pool)
        assert slab == {"fp": 512, "q8": 272, "q4": 144}[kind]
        assert fl == JA.paged_attn_cost(B, Hkv * G_, W, bs, D,
                                        slab_bytes=slab)[0]
        assert (nb, fl) == cs.paged_bytes_flops(
            q.reshape(B, Hkv, G_, D), pool, table, lens, 0)
        # chip_smoke counts this run's live tokens: ragged rows move less
        short = torch.tensor([0, 1, 15, 16, 33, 100, 200, 256],
                             dtype=torch.int32)
        nb2, fl2 = cs.paged_bytes_flops(q.reshape(B, Hkv, G_, D), pool,
                                        table, short, 0)
        assert (fl2, nb2) == A.paged_attn_cost(
            B, Hkv * G_, W, bs, D, slab_bytes=slab,
            tokens=int(short.sum()))
    # K4 at the q8/prefix and q4/prefix gathers
    for mode, R in (("q8", 28 * 64), ("q4", 28 * 7 * 64)):
        kv = quantize_kv(torch.randn((R, Hkv, D), generator=gen), mode=mode,
                         gr=gr, gc=gc)
        fl, nb = A.dequant_kv_cost(R, Hkv, D, mode, gr=gr, gc=gc)
        assert fl == JA.dequant_kv_cost(R, Hkv, D, mode)[0]
        assert (nb, fl) == cs.dequant_kv_bytes_flops(kv, mode, gr, gc)
        assert nb == kv["codes"].numel() + kv["scales"].numel() * 2 + 64 \
            + R * Hkv * D * 4
        view = {k: v.reshape(28, -1, 64, *v.shape[1:])
                for k, v in kv.items()}
        assert _recorded(ops.lut_dequant_gather, view) == (
            "lut_dequant_kv", fl, nb)
    # K5 and K6 keep the JAX package's counts; K6's bytes add its scales
    assert A.attn_cost(12, 2048, 2048, 128) == \
        JA.attn_cost(12, 2048, 2048, 128)
    for K, N in GEMM_KN:
        fl, nb = A.quantize_cost(K, N, scale_bytes=K * N // 16)
        assert fl == JA.quantize_cost(K, N)[0]
        assert nb == JA.quantize_cost(K, N)[1] + K * N // 16
        assert (nb, fl) == cs.quantize_bytes_flops(K, N)
    w = torch.randn((64, 32), generator=gen)
    assert _recorded(ops.tile_quantize_op, w)[1:] == \
        A.quantize_cost(64, 32, scale_bytes=64 * 32 // 16)


def test_plain_paged_attention_matches_reference_xla_branch():
    """The canary's exact path: ``"plain"`` against the JAX package's
    ``"xla"`` branch on the same pools and table (fp, Q8, Q4), recorded
    under the JAX package's op name, and reachable only by name."""
    rng = np.random.default_rng(0)
    B, Hkv, G_, D, bs, W, nb = 3, 2, 2, 16, 4, 5, 16
    gr, gc = kv_tile_geometry(Hkv, D)
    q = rng.standard_normal((B, 1, Hkv * G_, D)).astype(np.float32)
    table = np.zeros((B, W), np.int32)
    table[0] = [1, 2, 3, 4, 5]
    table[1, :2] = [9, 8]
    table[2, :3] = [12, 6, 7]
    lens = np.array([20, 7, 9], np.int32)
    for kind in ("fp", "q8", "q4"):
        fps = [rng.standard_normal((nb, bs, Hkv, D)).astype(np.float32)
               for _ in range(2)]
        if kind == "fp":
            jpools, tpools = fps, [torch.from_numpy(f) for f in fps]
        else:
            jpools = [JKQ.quantize_kv(jnp.asarray(f), mode=kind, gr=gr,
                                      gc=gc) for f in fps]
            tpools = [{k: bridge.to_tensor(np.asarray(v), "cpu")
                       for k, v in p.items()} for p in jpools]
        prev = JL.set_paged_attention_impl("xla")
        try:
            want = np.asarray(JL.paged_decode_attention(
                jnp.asarray(q), *jpools, table=jnp.asarray(table),
                cache_len=jnp.asarray(lens)))
        finally:
            JL.set_paged_attention_impl(prev)
        prev = L.set_paged_attention_impl(L.PLAIN_IMPL)
        try:
            name, _, _ = _recorded(
                L.paged_decode_attention, torch.from_numpy(q), *tpools,
                table=torch.from_numpy(table),
                cache_len=torch.from_numpy(lens))
            got = L.paged_decode_attention(
                torch.from_numpy(q), *tpools, table=torch.from_numpy(table),
                cache_len=torch.from_numpy(lens))
        finally:
            L.set_paged_attention_impl(prev)
        assert name == "paged_attention_xla"
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert L._PAGED_ATTN_IMPL in L.PAGED_ATTN_IMPLS
    assert L.PLAIN_IMPL not in L.PAGED_ATTN_IMPLS


# ---------------------------------------------------------------------------
# The profiler on the scheduler
# ---------------------------------------------------------------------------


@pytest.fixture
def counted(monkeypatch):
    """Count each wrapper's calls into its plain version as the kernel
    counts its launches, so the CPU run stands in for the card's."""
    def counting(wrapper, mod, name, key):
        plain = getattr(mod, name)

        def run(*a, **kw):
            wrapper.launches += 1
            return plain(*a, **kw)

        monkeypatch.setattr(mod, name, run)

    counting(G.lut_dequant_gemm, G, "plain_lut_dequant_gemm", None)
    counting(LK.lut_dequant_kv, LK, "plain_lut_dequant_kv", None)
    plain_pa = PA._plain

    def pa(q, k_pool, *a, **kw):
        w = PA.quant_paged_attention if isinstance(k_pool, dict) \
            else PA.paged_attention
        w.launches += 1
        return plain_pa(q, k_pool, *a, **kw)

    monkeypatch.setattr(PA, "_plain", pa)
    ops.reset_launch_counts()
    yield ops.launch_counts
    ops.reset_launch_counts()


def _engine(qweights, tiny_cfg, tok, kv_quant, n_blocks=48):
    return DecodeEngine(qweights, _torch_cfg(tiny_cfg), max_len=64,
                        eos_id=tok.eos_id, pad_id=tok.pad_id, paged=True,
                        block_size=8, n_blocks=n_blocks, kv_quant=kv_quant)


HEADER = "Q:1+2=?A:3.Q:4+4=?A:8."     # a shared 2-block prompt prefix
REQS = [(HEADER + "Q:2+7=?A:", 6, 1), (HEADER + "Q:1+1=?A:", 5, 2),
        (HEADER + "Q:9+9=?A:", 4, 1)]


def _serve(engine, tok, *, profiler=None, generator=None, sc=GREEDY,
           spec=None, cache=False):
    sched = ContinuousScheduler(
        engine, n_slots=4, prompt_len=PROMPT_LEN, stop_ids=NO_STOP,
        prefix_cache=PrefixCache(engine.pool) if cache else None,
        profiler=profiler, spec=spec)
    for i, (text, max_new, n) in enumerate(REQS):
        sched.submit(Request(req_id=i, prompt=torch.tensor(
            tok.encode(text), dtype=torch.int32), max_new_tokens=max_new,
            n_samples=n))
    try:
        res = sched.run(generator, sc)
    finally:
        if profiler is not None:
            profiler.uninstall()
    return sched, res


@pytest.mark.parametrize("route", ["prefix", "spec"])
def test_phase_op_calls_equal_launch_counters(qweights, tiny_cfg, tok,
                                              counted, route):
    """Every op the hook records is one kernel launch and the reverse: on
    a Q8 pool with the prefix cache (partial prefills gather through K4)
    and with self-drafted speculative rounds (the verify gathers through
    K4 and runs K3 at M = slots x W), outside the canary."""
    n_layers = tiny_cfg.n_layers
    eng = _engine(qweights, tiny_cfg, tok, "q8")
    prof = KernelProfiler(sample_rate=1.0, canary_rate=0.0,
                          clock=_counting_clock())
    sched, _ = _serve(eng, tok, profiler=prof, cache=route == "prefix",
                      spec=SpecConfig(k=3, self_draft=True)
                      if route == "spec" else None)
    counts = counted()
    rep = prof.report()
    k = rep["kernels"]
    assert k["lut_dequant_matmul"]["calls"] == counts["lut_dequant_gemm"]
    assert k["paged_flash_decode"]["calls"] == \
        counts["quant_paged_attention"]
    assert k["lut_dequant_kv"]["calls"] == counts["lut_dequant_kv"] > 0
    ph = rep["phases"]
    s = sched.metrics.summary()
    # per phase: one attention per layer per decode step; six Q4
    # projections per layer per forward; two K4 gathers per partial
    # prefill or verify
    assert k["paged_flash_decode"]["calls"] == n_layers * ph["decode"][
        "calls"]
    fwd = ph["decode"]["calls"] + ph["prefill"]["calls"] + \
        ph.get("spec_verify", {}).get("calls", 0)
    assert k["lut_dequant_matmul"]["calls"] == 6 * n_layers * fwd
    assert "untimed" not in ph
    if route == "spec":
        assert ph["spec_verify"]["calls"] == s["spec_rounds"] > 0
    else:
        assert s["prefix_cache_hits"] > 0
    assert ph["prefill"]["calls"] == s["prefill_calls"]
    assert rep["sampled_steps"] == rep["steps"] == s["steps"]
    assert s["profiled_steps"] == s["steps"]
    assert 0 < s["kernel_time_share"] and s["roofline_efficiency_p50"] > 0
    assert validate_profile_report(rep) == []
    assert JP.validate_profile_report(json.loads(json.dumps(rep))) == []
    assert eng.pool.blocks_in_use == sched.cache.n_cached_blocks \
        if sched.cache else eng.pool.blocks_in_use == 0


def _pool_bytes(engine):
    leaves = []
    for leaf in (engine.pool.k, engine.pool.v):
        leaves += list(leaf.values()) if isinstance(leaf, dict) else [leaf]
    return [t.clone() for t in leaves]


@pytest.mark.parametrize("kv,sampling", [("q8", "seeded"), ("q4", "seeded"),
                                         ("q8", "global"), ("q4", "greedy")])
def test_null_profiler_parity_with_canary(qweights, tiny_cfg, tok, kv,
                                          sampling):
    """A profiler sampling every step with a canary on every other step
    leaves the tokens, logprobs and every byte of the pool as a run
    without one: the canary samples from a copy of the generator (or a
    forked global RNG), and its token's KV write is the one production
    then writes."""
    sc = GREEDY if sampling == "greedy" else SamplerConfig(temperature=0.8)
    out = []
    for prof in (None, KernelProfiler(sample_rate=1.0, canary_rate=0.5,
                                      clock=_counting_clock())):
        torch.manual_seed(5)
        gen = torch.Generator().manual_seed(3) if sampling == "seeded" \
            else None
        eng = _engine(qweights, tiny_cfg, tok, kv)
        sched, res = _serve(eng, tok, profiler=prof, generator=gen, sc=sc)
        lps = [s.logprob_sum for rid in sorted(sched.completed)
               for s in sched.completed[rid]]
        out.append((res, lps, _pool_bytes(eng), prof))
        assert eng.pool.blocks_in_use == 0
    (r0, l0, p0, _), (r1, l1, p1, prof) = out
    assert r0 == r1 and l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    s = prof.summary_metrics()
    assert s["canary_samples"] == math.ceil(prof.report()["steps"] / 2) > 0
    assert ops.op_hook() is None
    assert L._PAGED_ATTN_IMPL == "exact"


def test_canary_zero_drift_under_greedy_q8(qweights, tiny_cfg, tok,
                                           monkeypatch):
    """A canary on every greedy Q8 step: no argmax flips, the max logit
    error within ``CANARY_ATOL``, a finite KV round-trip error per layer,
    and the "plain" impl selected only inside ``_canary_step``."""
    seen = []
    orig = L.paged_decode_attention
    in_canary = [False]
    orig_canary = DecodeEngine._canary_step

    def recording(*a, **kw):
        seen.append((L._PAGED_ATTN_IMPL, in_canary[0]))
        return orig(*a, **kw)

    def canary(self, *a, **kw):
        in_canary[0] = True
        try:
            return orig_canary(self, *a, **kw)
        finally:
            in_canary[0] = False

    monkeypatch.setattr(L, "paged_decode_attention", recording)
    monkeypatch.setattr(DecodeEngine, "_canary_step", canary)
    prof = KernelProfiler(sample_rate=1.0, canary_rate=1.0,
                          clock=_counting_clock())
    eng = _engine(qweights, tiny_cfg, tok, "q8")
    sched, _ = _serve(eng, tok, profiler=prof)
    s = sched.metrics.summary()
    assert s["canary_samples"] == s["steps"] > 0
    assert s["canary_argmax_flip_rate"] == 0.0
    assert s["canary_max_logit_err"] <= CANARY_ATOL
    errs = prof.report()["canary"]["kv_roundtrip_err_per_layer"]
    assert len(errs) == tiny_cfg.n_layers
    assert all(math.isfinite(e) and e >= 0 for e in errs)
    assert {impl for impl, inside in seen if inside} == {L.PLAIN_IMPL}
    assert {impl for impl, inside in seen if not inside} == {"exact"}
    assert not prof.warnings
