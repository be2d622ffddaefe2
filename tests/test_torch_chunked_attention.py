"""The port's chunked attention (``repro_torch.models.layers``) against the
JAX package's ``chunked_attention`` at the same chunk sizes, small enough
that chunk boundaries, padding and the kv sentinel are crossed at small
S: outputs and gradients (JAX's ``jax.grad`` through its checkpointed
scan), f32 and bf16; the skip of causally hidden kv chunks; the loop's
working set under the dry-run's live-storage meter against the rule
that the dry-run charges on ``meta``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as L

QC, KC = 16, 32
F32_TOL = 1e-5
# bf16 operands: both sides round p to bf16 for P.V and every result to
# bf16; the sums run in different orders (and the grads through different
# rounding points), so an element may land up to two bf16 steps (2^-7 of
# its magnitude each) apart, plus an absolute 2e-2 near zero
BF16_TOL = 2e-2
BF16_RTOL = 2.0 ** -6

# name -> (B, Sq, Skv, Hq, Hkv, D, causal, window, softcap, prefix)
CASES = {
    "causal": (2, 45, 45, 4, 2, 8, True, 0, 0.0, False),
    "noncausal": (2, 37, 70, 4, 4, 8, False, 0, 0.0, False),
    "window": (1, 50, 50, 6, 2, 8, True, 7, 0.0, False),
    "softcap": (2, 33, 33, 4, 1, 16, True, 0, 5.0, False),
    "prefix": (3, 19, 19 + 29, 4, 2, 8, True, 0, 0.0, True),
    "exact": (1, 32, 64, 2, 1, 8, True, 0, 0.0, False),
}


def _inputs(name, dtype=np.float32):
    B, Sq, Skv, Hq, Hkv, D, causal, window, softcap, prefix = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    do = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    if prefix:
        # ragged cached prefixes of P = Skv - Sq slots: invalid slots at
        # P + Sq, past every query; the suffix at len[b] + j
        P = Skv - Sq
        lens = np.array([29, 3, 0][:B], np.int32)
        slots = np.arange(P)[None]
        pre = np.where(slots < lens[:, None], slots, P + Sq)
        qpos = lens[:, None] + np.arange(Sq)[None]
        kvpos = np.concatenate([pre, qpos], 1)
    else:
        qpos = np.broadcast_to(np.arange(Sq)[None], (B, Sq))
        kvpos = np.broadcast_to(np.arange(Skv)[None], (B, Skv))
    kw = dict(causal=causal, window=window, softcap=softcap)
    return (q, k, v, do, qpos.astype(np.int32), kvpos.astype(np.int32), kw)


def _jax(q, k, v, do, qpos, kvpos, kw, dtype):
    """The JAX function's output and its vjp of ``do``, jitted as one
    program (eager JAX compiles the scan op by op)."""
    def f(q, k, v, do):
        o, vjp = jax.vjp(lambda q, k, v: JL.chunked_attention(
            q, k, v, q_positions=qpos, kv_positions=kvpos, q_chunk=QC,
            kv_chunk=KC, **kw), q, k, v)
        return (o, *vjp(do))

    args = [jnp.asarray(a, dtype) for a in (q, k, v, do)]
    return [np.asarray(t, np.float32) for t in jax.jit(f)(*args)]


def _torch(q, k, v, do, qpos, kvpos, kw, dtype, aligned=False):
    args = [torch.tensor(a).to(dtype).requires_grad_(True) for a in (q, k, v)]
    o = L.chunked_attention(*args, q_positions=torch.tensor(qpos),
                            kv_positions=torch.tensor(kvpos), q_chunk=QC,
                            kv_chunk=KC, aligned=aligned, **kw)
    grads = torch.autograd.grad(o, args, torch.tensor(do).to(dtype))
    return [t.detach().float().numpy() for t in (o, *grads)]


@pytest.mark.parametrize("name", list(CASES))
def test_chunked_attention_matches_jax_f32(name):
    q, k, v, do, qpos, kvpos, kw = _inputs(name)
    want = _jax(q, k, v, do, qpos, kvpos, kw, jnp.float32)
    got = _torch(q, k, v, do, qpos, kvpos, kw, torch.float32)
    for part, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=F32_TOL, rtol=0,
                                   err_msg=f"{name} {part}")


@pytest.mark.parametrize("name", ["causal", "softcap", "prefix"])
def test_chunked_attention_matches_jax_bf16(name):
    q, k, v, do, qpos, kvpos, kw = _inputs(name)
    want = _jax(q, k, v, do, qpos, kvpos, kw, jnp.bfloat16)
    got = _torch(q, k, v, do, qpos, kvpos, kw, torch.bfloat16)
    for part, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=BF16_TOL, rtol=BF16_RTOL,
                                   err_msg=f"{name} {part}")


@pytest.mark.parametrize("name", ["causal", "window", "softcap", "exact"])
def test_skipping_hidden_chunks_changes_nothing(name):
    """``aligned`` causal calls skip the kv chunks wholly past a q chunk:
    outputs and grads bit-equal to the loop over every chunk, with fewer
    tiles (the count the dry-run charges)."""
    q, k, v, do, qpos, kvpos, kw = _inputs(name)
    full = _torch(q, k, v, do, qpos, kvpos, kw, torch.float32)
    skip = _torch(q, k, v, do, qpos, kvpos, kw, torch.float32, aligned=True)
    for a, b in zip(full, skip):
        np.testing.assert_array_equal(a, b)
    B, Sq, Skv, Hq, Hkv, D = CASES[name][:6]
    geo = L._Geometry(torch.empty(B, Sq, Hq, D), torch.empty(B, Skv, Hkv, D),
                      QC, KC)
    assert geo.tiles(True, True) < geo.tiles(True, False) == geo.nq * geo.nkv


def _meter_peak(fn, known=()):
    """The dry-run's meter around ``fn``: (peak live bytes allocated
    inside, less the storages of what ``fn`` returns; its result)."""
    from repro_torch.launch.dryrun import _Meter, _storages

    meter = _Meter(_storages(known))
    with meter:
        out = fn()
    ret = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
           for t in (out if isinstance(out, tuple) else (out,))}
    return meter.peak - sum(ret.values()), out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_working_set_matches_the_meta_rule(dtype):
    """The real loop at a small shape under the dry-run's live-storage
    meter: its peak, less what it returns (the output; the input grads),
    is the working set that ``chunked_attention_workspace`` charges on
    ``meta``, within a few chunk-sized tensors (two q chunks and a kv
    chunk: a second score tile would fail it); and the meta rule
    allocates exactly that."""
    B, S, Hq, Hkv, D, qc, kc = 2, 300, 8, 2, 16, 64, 128
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(B, S, h, D, generator=g).to(dtype)
               for h in (Hq, Hkv, Hkv))
    pos = torch.arange(S)[None].expand(B, S)
    geo = L._Geometry(q, k, qc, kc)
    isz = q.element_size()
    qf, kvf = 4 * B * Hq * qc * D, 4 * B * Hkv * kc * D
    slack = 2 * qf + kvf
    assert slack < 4 * B * Hq * qc * kc

    def fwd(q=q, k=k, v=v):
        return L.chunked_attention(q, k, v, q_positions=pos,
                                   kv_positions=pos, q_chunk=qc,
                                   kv_chunk=kc, aligned=True)

    with torch.no_grad():
        got, out = _meter_peak(fwd, (q, k, v, pos))
    rule = L.chunked_attention_workspace(geo, isz)
    assert abs(got - rule) <= slack, (got, rule)

    qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
    o = fwd(qq, kk, vv)
    do = torch.randn(o.shape, generator=g).to(dtype)
    got_b, _ = _meter_peak(lambda: torch.autograd.grad(o, (qq, kk, vv), do),
                           (qq, kk, vv, o, do, pos))
    rule_b = L.chunked_attention_workspace(geo, isz, backward=True)
    assert abs(got_b - rule_b) <= slack, (got_b, rule_b)

    # the meta rule allocates exactly its working set, and costs the op
    from repro_torch.kernels import ops
    calls = []
    prev = ops.set_op_hook(lambda *a: calls.append(a))
    try:
        qm, km, vm, pm = (t.to("meta") for t in (q, k, v, pos))
        peak_m, om = _meter_peak(lambda: L.chunked_attention(
            qm, km, vm, q_positions=pm, kv_positions=pm, q_chunk=qc,
            kv_chunk=kc, aligned=True), (qm, km, vm, pm))
    finally:
        ops.set_op_hook(prev)
    assert om.shape == q.shape and om.dtype == dtype
    assert peak_m == rule
    assert [c[0] for c in calls] == ["chunked_attention"]
    assert calls[0][1] == 4.0 * B * Hq * qc * kc * D * geo.tiles(True, True)


def test_meta_backward_costs_the_recompute():
    from repro_torch.kernels import ops

    B, S, Hq, Hkv, D = 1, 100, 4, 2, 8
    q = torch.empty(B, S, Hq, D, device="meta", requires_grad=True)
    k = torch.empty(B, S, Hkv, D, device="meta", requires_grad=True)
    v = torch.empty(B, S, Hkv, D, device="meta", requires_grad=True)
    pos = torch.empty(B, S, dtype=torch.int32, device="meta")
    calls = []
    prev = ops.set_op_hook(lambda *a: calls.append(a))
    try:
        o = L.chunked_attention(q, k, v, q_positions=pos, kv_positions=pos,
                                q_chunk=QC, kv_chunk=KC)
        dq, dk, dv = torch.autograd.grad(o.sum(), (q, k, v))
    finally:
        ops.set_op_hook(prev)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert [c[0] for c in calls] == ["chunked_attention",
                                     "chunked_attention_bwd"]
    assert calls[1][1] == 2.5 * calls[0][1]


# -- the transformer at a sequence over one chunk (512 queries) --------------

LONG_S = 600


def _long_cfgs(tiny_cfg, **kw):
    """(JAX cfg, port cfg): ``tiny_cfg`` with a local:global window (so a
    causal chunk skip and a window cross the chunk boundaries) and remat
    (the chunked backward under ``torch.utils.checkpoint``)."""
    import dataclasses

    from repro_torch.configs.base import ModelConfig

    jc = dataclasses.replace(tiny_cfg, attn_pattern="local_global:1",
                             window_size=300, **kw)
    return jc, ModelConfig(**dataclasses.asdict(jc))


def test_transformer_prefill_over_one_chunk_matches_jax(tiny_cfg):
    """Prefill logits and every layer's cache at S = 600 (two q chunks)
    within 1e-5 of the JAX package's chunked prefill."""
    from repro.models import transformer as JT
    from repro_torch import bridge
    from repro_torch.models import transformer as T

    jc, tc = _long_cfgs(tiny_cfg)
    tp = T.init_params(tc, seed=2, device="cpu")
    jp = bridge.params_to_jax(tp)
    rng = np.random.default_rng(5)
    toks = rng.integers(3, 300, (2, LONG_S)).astype(np.int32)
    lens = np.array([LONG_S, 431], np.int32)
    jl, jcache = jax.jit(lambda p, t, n: JT.prefill(
        p, t, jc, max_len=LONG_S, lengths=n))(jp, jnp.asarray(toks),
                                              jnp.asarray(lens))
    cache = T.init_cache(tc, 2, LONG_S, device="cpu")
    with torch.no_grad():
        tl = T.prefill(tp, torch.from_numpy(toks), tc,
                       lengths=torch.from_numpy(lens), cache=cache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=F32_TOL,
                               rtol=0)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), atol=F32_TOL,
                                   rtol=0)


def test_train_loss_and_grads_over_one_chunk_match_jax(tiny_cfg):
    """``lm_loss`` and every grad leaf at S = 600 under full remat against
    ``jax.value_and_grad`` of the reference's (its checkpointed scan):
    the loss within 1e-5 relative, each leaf within 1e-4 of its largest
    element (``tests/test_torch_train.py``'s bars)."""
    from repro.train import loop as JTL
    from repro_torch import bridge
    from repro_torch.models import transformer as T
    from repro_torch.train import loop as TL

    jc, tc = _long_cfgs(tiny_cfg, remat="full")
    tp = T.init_params(tc, seed=3, device="cpu")
    jp = bridge.params_to_jax(tp)
    rng = np.random.default_rng(6)
    batch = (rng.integers(3, 300, (2, LONG_S)).astype(np.int32),
             rng.integers(3, 300, (2, LONG_S)).astype(np.int32),
             (rng.random((2, LONG_S)) > 0.2).astype(np.float32))
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JTL.lm_loss(p, b, jc, None), has_aux=True))(
            jp, tuple(jnp.asarray(b) for b in batch))
    (tl, _), tg = TL.value_and_grad(
        tp, tuple(torch.from_numpy(b) for b in batch), tc)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    want = bridge.params_from_jax(jax.device_get(jg), device="cpu")
    from repro_torch import tree as TT
    got_l, want_l = TT.stacked_leaves(tg), TT.stacked_leaves(want)
    top = max(float(torch.stack(w).abs().max()) for _, w, _ in want_l)
    for (path, g, _), (_, w, _) in zip(got_l, want_l):
        g, w = torch.stack(g), torch.stack(w)
        scale = max(float(w.abs().max()), 1e-3 * top)
        assert float((g - w).abs().max()) <= 1e-4 * scale, path
