"""The port's prefix-cache slice against the JAX package, on the same
weights (via ``repro_torch.bridge``), tokens and operation sequences:

* the radix tree: both packages' ``PrefixCache`` over their own
  ``KVPool``, driven by one sequence of operations, must return the same
  block ids and leave equal refcounts, free lists and stats;
* partial prefill: aligned, mid-block and ragged cached lengths on
  none/q8/q4 pools give the reference's logits (the tolerances of
  ``test_torch_model.py``) and pool contents, with the reference's
  validation errors and an atomic ``OutOfBlocks``;
* the scheduler: cache-aware admission (a cold header, a batched hit
  round, TTS groups) gives the reference's greedy samples, hits, leases,
  prefill-token savings and admission batch sizes, also under eviction
  churn.  q4 is held against the reference's q4 outputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import controller as JC
from repro.core.reward import OracleVerifier as JOracle
from repro.data import tasks as JT
from repro.models import api as japi
from repro.serving import kv_pool as JKP
from repro.serving import prefix_cache as JPC
from repro.serving.engine import ContinuousScheduler as JSched
from repro.serving.engine import DecodeEngine as JEngine
from repro.serving.engine import Request as JRequest
from repro.serving.sampler import SamplerConfig as JSampler
from repro_torch import bridge
from repro_torch.configs.base import ModelConfig
from repro_torch.core import controller as C
from repro_torch.core.reward import OracleVerifier
from repro_torch.data import tasks as T
from repro_torch.serving.engine import ContinuousScheduler, DecodeEngine, \
    Request
from repro_torch.serving.kv_pool import KVPool, OutOfBlocks
from repro_torch.serving.kv_quant import dequantize_kv, kv_geometry
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.sampler import SamplerConfig

# logits: f32 on both sides, summed in other orders (~1e-6); a quantized
# pool can turn that into one flipped KV code, one quantization step of
# that element (q8 step = absmax/127, q4 step = absmax/8)
ATOL = {"none": 1e-5, "q8": 2e-3, "q4": 2e-2}
NO_STOP = (9999,)


def _torch_cfg(cfg):
    return ModelConfig(**{f: getattr(cfg, f) for f in (
        "name", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
        "vocab_size", "dtype", "param_dtype")})


def _norm(x):
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, (np.integer, np.ndarray)):
        return np.asarray(x).tolist()
    return x


# ---------------------------------------------------------------------------
# Radix tree: one operation sequence through both packages
# ---------------------------------------------------------------------------


class Twin:
    """A JAX-package pool + cache and the port's, driven in lockstep; every
    call must return the same value and leave the same accounting."""

    def __init__(self, tiny_cfg, n_blocks, block_size, capacity=None):
        self.jpool = JKP.KVPool(tiny_cfg, n_blocks, block_size)
        self.tpool = KVPool(_torch_cfg(tiny_cfg), n_blocks, block_size,
                            device="cpu")
        self.jcache = JPC.PrefixCache(self.jpool, capacity_blocks=capacity)
        self.tcache = PrefixCache(self.tpool, capacity_blocks=capacity)

    def pool(self, method, *args):
        return self._both(self.jpool, self.tpool, method, args)

    def cache(self, method, *args):
        return self._both(self.jcache, self.tcache, method, args)

    def _both(self, j, t, method, args):
        want = getattr(j, method)(*args)
        got = getattr(t, method)(*args)
        assert _norm(got) == _norm(want), method
        np.testing.assert_array_equal(self.tpool.refcount,
                                      self.jpool.refcount)
        assert self.tpool._free == self.jpool._free
        assert self.tcache.stats() == self.jcache.stats()
        assert self.tcache.cached_block_ids() == \
            self.jcache.cached_block_ids()
        return got


def test_match_insert_longest_prefix(tiny_cfg):
    tw = Twin(tiny_cfg, 32, 4)
    toks = list(range(100, 112))                 # 3 full blocks
    blocks = tw.pool("alloc", 3)
    assert tw.cache("insert", toks, blocks) == 3
    got, clen = tw.cache("match", toks)
    assert clen == 12 and got == blocks
    tw.pool("release", got)
    for query in (toks[:8] + [7, 7, 7, 7], [1, 2, 3, 4], toks[:10],
                  toks[:8] + [7, 7]):
        assert tw.cache("probe", query) == tw.jcache.probe(query)
        got, clen = tw.cache("match", query)
        tw.pool("release", got)
    assert tw.cache("potential_match", toks[:10], toks) == 10
    assert tw.cache("insert", toks, blocks) == 0  # idempotent re-insert


def test_insert_skips_partial_trailing_block(tiny_cfg):
    tw = Twin(tiny_cfg, 16, 4)
    blocks = tw.pool("alloc", 3)
    assert tw.cache("insert", list(range(10)), blocks) == 2
    assert tw.tpool.refcount[blocks[2]] == 1     # tail never pinned


def test_lru_eviction_frees_leaves_only(tiny_cfg):
    tw = Twin(tiny_cfg, 32, 4)
    shared = list(range(8))
    a, b = tw.pool("alloc", 3), tw.pool("alloc", 3)
    tw.cache("insert_batch", [(shared + [20, 21, 22, 23], a),
                              (shared + [30, 31, 32, 33], b)])
    tw.pool("release", a)
    tw.pool("release", b)
    got, _ = tw.cache("match", shared + [30, 31, 32, 33])
    tw.pool("release", got)
    assert tw.cache("evict", 1) == 1
    assert tw.cache("match", shared + [20, 21, 22, 23])[1] == 8
    assert tw.tcache.n_cached_blocks == 3


def test_evict_skips_blocks_leased_to_live_rows(tiny_cfg):
    tw = Twin(tiny_cfg, 16, 4)
    blocks = tw.pool("alloc", 2)
    tw.cache("insert", list(range(8)), blocks)
    tw.pool("release", blocks)
    leased, clen = tw.cache("match", list(range(8)))
    assert clen == 8
    assert tw.cache("evict", 2) == 0             # leased: nothing to free
    tw.pool("release", leased)
    assert tw.cache("evict", 2) == 2
    assert tw.tpool.blocks_in_use == 0


def test_pressure_hook_and_capacity(tiny_cfg):
    tw = Twin(tiny_cfg, 9, 4, capacity=2)
    assert tw.tpool.pressure_hook == tw.tcache.evict
    b = tw.pool("alloc", 4)
    assert tw.cache("insert", list(range(16)), b) == 2   # capacity cap
    tw.pool("release", b)
    assert tw.pool("reserve", 8)         # reclaims both through the hook
    assert tw.tcache.n_cached_blocks == 0 and tw.tpool.free_blocks == 8
    tw.pool("release", tw.pool("alloc", 8))


def test_clear_and_cached_block_ids(tiny_cfg):
    tw = Twin(tiny_cfg, 16, 4)
    b = tw.pool("alloc", 3)
    tw.cache("insert", list(range(12)), b)
    tw.pool("release", b)
    assert tw.tcache.cached_block_ids() == set(b)
    assert tw.cache("clear") == 3
    assert tw.tpool.blocks_in_use == 0


# ---------------------------------------------------------------------------
# Partial prefill: engine level
# ---------------------------------------------------------------------------

PROMPT = list(range(40, 63))        # 23 tokens


def _engines(tiny_cfg, kv, *, n_blocks=40, seed=9, max_len=64):
    jp = japi.get_model(tiny_cfg).init_params(jax.random.key(seed), tiny_cfg)
    kw = dict(max_len=max_len, eos_id=1, pad_id=0, block_size=8,
              n_blocks=n_blocks, kv_quant=kv)
    jeng = JEngine(jp, tiny_cfg, paged=True, **kw)
    teng = DecodeEngine(bridge.params_from_jax(jax.device_get(jp),
                                               device="cpu"),
                        _torch_cfg(tiny_cfg), paged=True, **kw)
    return jeng, teng


def _partial(eng, clens, *, jax_side):
    """Full prefill of PROMPT (B=1), then one batched partial prefill of
    rows caching its first ``clens[i]`` tokens; returns (partial logits,
    partial table)."""
    if jax_side:
        full = eng.prefill(jnp.asarray(PROMPT)[None])
        src = np.asarray(jax.device_get(full.cache["table"]))[0]
    else:
        full = eng.prefill(torch.tensor(PROMPT, dtype=torch.int32)[None])
        src = full.table[0]
    B, bs = len(clens), eng.pool.block_size
    S = len(PROMPT) - min(clens)
    toks = np.zeros((B, S), np.int32)
    ctab = np.zeros((B, eng.table_width), np.int32)
    for i, c in enumerate(clens):
        n = -(-c // bs)
        ctab[i, :n] = src[:n]
        eng.pool.retain(src[:n])               # the lease match would take
        toks[i, :len(PROMPT) - c] = PROMPT[c:]
    lens = np.array([len(PROMPT) - c for c in clens], np.int32)
    if jax_side:
        st = eng.prefill(jnp.asarray(toks), jnp.asarray(lens),
                         cached_table=ctab, cached_lens=np.array(clens))
        return (np.asarray(st.pending_logits),
                np.asarray(jax.device_get(st.cache["table"])))
    st = eng.prefill(torch.from_numpy(toks), torch.from_numpy(lens),
                     cached_table=ctab, cached_lens=np.array(clens))
    return st.pending_logits.numpy(), st.table


def _pool_values(pool):
    """(n_blocks, ...) f32 K and V of every block but the scratch block
    (padding writes land there in an unspecified order), with the
    quantization step of each element (0 for fp pools)."""
    out = []
    for leaf in (pool.k, pool.v):
        if isinstance(leaf, dict):
            leaf = {k: torch.as_tensor(np.array(v))[:, 1:]
                    for k, v in leaf.items()}
            _, gr, gc, _ = kv_geometry(leaf)
            step = leaf["scales"].float().repeat_interleave(
                gr, -2).repeat_interleave(gc, -1)
            out.append((dequantize_kv(leaf).numpy(), step.numpy()))
        else:
            v = np.asarray(leaf)[:, 1:]
            out.append((v, np.zeros_like(v)))
    return out


@pytest.mark.parametrize("kv", ["none", "q8", "q4"])
@pytest.mark.parametrize("clens", [[8], [11], [16, 11, 5]])
def test_partial_prefill_matches_reference(tiny_cfg, kv, clens):
    """Aligned (8, 16), mid-block (5, 11) and ragged batched cached
    lengths: logits within the model tolerances, identical block tables,
    and pool contents equal after the suffix scatter (to one quantization
    step of an element, where a ~1e-6 difference flipped a code)."""
    jeng, teng = _engines(tiny_cfg, kv)
    jl, jtab = _partial(jeng, clens, jax_side=True)
    tl, ttab = _partial(teng, clens, jax_side=False)
    np.testing.assert_allclose(tl, jl, atol=ATOL[kv])
    np.testing.assert_array_equal(ttab, jtab)
    np.testing.assert_array_equal(teng.pool.refcount, jeng.pool.refcount)
    assert teng.pool.cow_copies == jeng.pool.cow_copies == \
        sum(1 for c in clens if c % 8)
    for (tv, step), (jv, _) in zip(_pool_values(teng.pool),
                                   _pool_values(jeng.pool)):
        assert np.all(np.abs(tv - jv) <= 1.001 * step + 1e-5)


def test_partial_prefill_validates_inputs_like_reference(tiny_cfg):
    jeng, teng = _engines(tiny_cfg, "none")
    jst = jeng.prefill(jnp.asarray(PROMPT[:12])[None])
    tst = teng.prefill(torch.tensor(PROMPT[:12], dtype=torch.int32)[None])
    table = tst.table[:, :1]
    cases = [  # zero-token suffix, overrun, row-count mismatch
        (np.ones((1, 4), np.int32), np.array([0], np.int32), [8]),
        (np.ones((1, 60), np.int32), np.array([60], np.int32), [8]),
        (np.ones((1, 4), np.int32), np.array([4], np.int32), [8, 8]),
    ]
    for toks, lens, clens in cases:
        with pytest.raises(ValueError):
            jeng.prefill(jnp.asarray(toks), jnp.asarray(lens),
                         cached_table=table, cached_lens=np.array(clens))
        with pytest.raises(ValueError):
            teng.prefill(torch.from_numpy(toks), torch.from_numpy(lens),
                         cached_table=table, cached_lens=np.array(clens))
    jeng.release_rows(jst, [0])
    teng.release_rows(tst, [0])
    assert teng.pool.blocks_in_use == jeng.pool.blocks_in_use == 0


def test_partial_prefill_out_of_blocks_is_atomic(tiny_cfg):
    """A partial prefill the pool cannot cover raises before any retain,
    CoW or alloc: refcounts and free list are untouched, lease included."""
    _, eng = _engines(tiny_cfg, "q8", n_blocks=4)     # capacity 3
    prompt = PROMPT[:12]                              # 2 blocks
    st = eng.prefill(torch.tensor(prompt, dtype=torch.int32)[None])
    cached = st.table[0, :1]
    eng.pool.retain(cached)
    rc, free = eng.pool.refcount.copy(), list(eng.pool._free)
    suffix = torch.tensor(prompt[8:] + prompt, dtype=torch.int32)[None]
    with pytest.raises(OutOfBlocks):
        eng.prefill(suffix, cached_table=cached[None],
                    cached_lens=np.array([8]))
    np.testing.assert_array_equal(eng.pool.refcount, rc)
    assert eng.pool._free == free
    eng.pool.release(cached)
    eng.release_rows(st, [0])
    assert eng.pool.blocks_in_use == 0


# ---------------------------------------------------------------------------
# Scheduler: cache-aware admission
# ---------------------------------------------------------------------------

HEADER = "Q:1+2=?A:3.Q:4+5=?A:9.Q:7+2=?A:9."
# plain, plain, plain, a Best-of-2 group, plain: a cold header, then a
# batched hit round, a cached group and a late plain hit in one step
WORKLOAD = [("Q:1+2=?A:", 1), ("Q:3+4=?A:", 1), ("Q:5+6=?A:", 1),
            ("Q:2+2=?A:", 2), ("Q:7+8=?A:", 1)]
KEYS = ("prefix_cache_lookups", "prefix_cache_hits", "prefill_tokens_saved",
        "prefill_calls", "admission_batch_max", "admitted_requests",
        "prefill_tokens", "decode_tokens", "steps", "preemptions")


def _serve_cached(tok, tiny_cfg, kv, *, n_blocks, n_slots, capacity,
                  max_new=4):
    jeng, teng = _engines(tiny_cfg, kv, n_blocks=n_blocks, seed=11)
    out = []
    for side, eng in (("jax", jeng), ("torch", teng)):
        if side == "jax":
            cache = JPC.PrefixCache(eng.pool, capacity_blocks=capacity)
            sched = JSched(eng, n_slots=n_slots, prompt_len=48,
                           stop_ids=NO_STOP, prefix_cache=cache)
        else:
            cache = PrefixCache(eng.pool, capacity_blocks=capacity)
            sched = ContinuousScheduler(eng, n_slots=n_slots, prompt_len=48,
                                        stop_ids=NO_STOP, prefix_cache=cache)
        for i, (q, n) in enumerate(WORKLOAD):
            ids = tok.encode(HEADER + q)
            if side == "jax":
                sched.submit(JRequest(req_id=i, prompt=jnp.asarray(ids),
                                      max_new_tokens=max_new, n_samples=n))
            else:
                sched.submit(Request(req_id=i, prompt=torch.tensor(
                    ids, dtype=torch.int32), max_new_tokens=max_new,
                    n_samples=n))
        if side == "jax":
            res = sched.run(jax.random.key(0), JSampler(greedy=True))
        else:
            res = sched.run(torch.Generator().manual_seed(0),
                            SamplerConfig(greedy=True))
        assert eng.pool.blocks_in_use == cache.n_cached_blocks  # drained
        out.append((res, sched, cache))
    return out


@pytest.mark.parametrize("kv", ["none", "q8", "q4"])
def test_scheduler_with_cache_matches_reference(tok, tiny_cfg, kv):
    (jres, jsched, jcache), (tres, tsched, tcache) = _serve_cached(
        tok, tiny_cfg, kv, n_blocks=97, n_slots=6, capacity=None)
    assert tres == jres                          # greedy samples
    jm, tm = jsched.metrics.summary(), tsched.metrics.summary()
    for key in KEYS:
        assert tm[key] == jm[key], key
    assert tsched.metrics.admission_batch_sizes == \
        jsched.metrics.admission_batch_sizes
    assert tcache.stats() == jcache.stats()      # tokens_matched included
    # the cold header prefills once; the followers hit, two in one call
    assert tm["prefix_cache_hits"] == len(WORKLOAD) - 1
    assert tm["admission_batch_max"] == 2
    assert tm["prefill_calls_per_request"] < 1.0


@pytest.mark.parametrize("n_blocks,n_slots,capacity", [
    (9, 2, None),      # starved pool: the pressure hook evicts
    (97, 2, 5),        # capacity cap: inserts evict LRU leaves
])
def test_scheduler_under_eviction_churn_matches_reference(
        tok, tiny_cfg, n_blocks, n_slots, capacity):
    (jres, jsched, jcache), (tres, tsched, tcache) = _serve_cached(
        tok, tiny_cfg, "q8", n_blocks=n_blocks, n_slots=n_slots,
        capacity=capacity)
    assert tres == jres
    jm, tm = jsched.metrics.summary(), tsched.metrics.summary()
    for key in KEYS:
        assert tm[key] == jm[key], key
    assert tcache.stats() == jcache.stats()
    assert tcache.stats()["evictions"] > 0


def test_controller_row_reports_cache_stats_like_reference(tok, tiny_cfg):
    jeng, teng = _engines(tiny_cfg, "q4", n_blocks=97, seed=12, max_len=96)
    kw = dict(n=2, max_tokens=6, n_slots=4)
    want = JC.serve_best_of_n(
        jeng, tok, JT.shared_prefix_dataset(41, 3, n_shots=1, max_terms=2),
        rng=jax.random.key(0), scorer=JOracle(), sc=JSampler(greedy=True),
        prefix_cache=JPC.PrefixCache(jeng.pool), **kw)
    got = C.serve_best_of_n(
        teng, tok, T.shared_prefix_dataset(41, 3, n_shots=1, max_terms=2),
        rng=torch.Generator().manual_seed(0), scorer=OracleVerifier(),
        sc=SamplerConfig(greedy=True), prefix_cache=PrefixCache(teng.pool),
        **kw)
    assert got["serving"]["prefix_cache"] == want["serving"]["prefix_cache"]
    assert got["serving"]["prefix_cache"]["hits"] == 2
    for key in ("accuracy", "decode_tokens"):
        assert got[key] == want[key], key
    for key in KEYS:
        assert got["serving"][key] == want["serving"][key], key


def test_scheduler_rejects_foreign_cache_and_bad_batch_cap(tok, tiny_cfg):
    """A cache bound to another pool is refused, and the free slots cap
    one admission prefill: with two slots, the two plain hits the
    six-slot run admits together go in one at a time, as in the JAX
    scheduler."""
    _, a = _engines(tiny_cfg, "none")
    _, b = _engines(tiny_cfg, "none")
    with pytest.raises(ValueError):
        ContinuousScheduler(a, prefix_cache=PrefixCache(b.pool))
    (jres, jsched, _), (tres, tsched, _) = _serve_cached(
        tok, tiny_cfg, "none", n_blocks=97, n_slots=2, capacity=None)
    assert tres == jres
    assert tsched.metrics.admission_batch_sizes == \
        jsched.metrics.admission_batch_sizes
    assert max(tsched.metrics.admission_batch_sizes) == 1
