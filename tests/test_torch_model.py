"""The port's model against the JAX package's on the same weights (carried
by ``repro_torch.bridge``) and tokens: prefill and paged decode logits over
fp, Q8 and Q4 pools, with fp and W4A16 weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import api as japi
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.quant.qlinear import quantize_model_params as jax_quantize
from repro.serving import kv_pool as JKP
from repro.serving import kv_quant as JKQ
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.serving.kv_pool import KVPool
from repro_torch.serving.kv_quant import QuantKVPool

# Both sides compute in f32; summation order differs (~1e-6 on these
# logits).  A quantized pool can turn such a difference into one flipped
# KV code at a rounding boundary, one quantization step of that element:
# the bars cover that (q8 step = absmax/127, q4 step = absmax/8).
ATOL = {"none": 1e-5, "q8": 2e-3, "q4": 2e-2}
BS, W, STEPS = 4, 8, 4


def _jax_pool(cfg, kv):
    nb = 1 + 3 * W
    if kv == "none":
        return JKP.KVPool(cfg, nb, BS)
    return JKQ.QuantKVPool(cfg, nb, BS, mode=kv)


def _torch_pool(cfg, kv):
    nb = 1 + 3 * W
    if kv == "none":
        return KVPool(cfg, nb, BS, device="cpu")
    return QuantKVPool(cfg, nb, BS, mode=kv, device="cpu")


def _run_pair(jparams, cfg_j, cfg_t, kv, *, lut=False, seed=0):
    """Prefill 3 ragged prompts, then STEPS teacher-forced decode steps
    (tokens = the reference's greedy picks) in both packages; returns the
    stacked (STEPS+1, B, V) logits of each."""
    tparams = bridge.params_from_jax(jax.device_get(jparams), device="cpu")
    rng = np.random.default_rng(seed)
    lens = np.array([9, 4, 13], np.int32)
    toks = rng.integers(3, 300, (3, 13)).astype(np.int32)
    table = np.zeros((3, W), np.int32)
    table[:, :5] = np.arange(1, 16, dtype=np.int32).reshape(3, 5)

    jpool, tpool = _jax_pool(cfg_j, kv), _torch_pool(cfg_t, kv)
    jl, jcache = jax.jit(lambda p, t, n, c: JT.prefill(
        p, t, cfg_j, max_len=W * BS, lengths=n, paged=c))(
        jparams, jnp.asarray(toks), jnp.asarray(lens),
        {"k": jpool.k, "v": jpool.v, "table": jnp.asarray(table)})
    tcache = {"k": tpool.k, "v": tpool.v, "table": torch.from_numpy(table)}
    tl = T.prefill(tparams, torch.from_numpy(toks), cfg_t,
                   lengths=torch.from_numpy(lens), paged=tcache)
    jout, tout = [np.asarray(jl)], [tl.numpy()]
    clen = lens.copy()
    prev_j = JL.set_paged_attention_impl("kernel_lut" if lut else "xla")
    prev_t = L.set_paged_attention_impl("lut" if lut else "exact")
    try:
        # a fresh wrapper per call: the impl switch is read at trace time
        jstep = jax.jit(lambda p, t, c, n: JT.decode_step(p, t, c, n, cfg_j))
        for _ in range(STEPS):
            nxt = np.argmax(jout[-1], axis=-1).astype(np.int32)[:, None]
            clen = clen + 1
            jl, jcache = jstep(jparams, jnp.asarray(nxt), jcache,
                               jnp.asarray(clen))
            tl = T.decode_step(tparams, torch.from_numpy(nxt), tcache,
                               torch.from_numpy(clen), cfg_t)
            jout.append(np.asarray(jl))
            tout.append(tl.numpy())
    finally:
        JL.set_paged_attention_impl(prev_j)
        L.set_paged_attention_impl(prev_t)
    return np.stack(jout), np.stack(tout)


def _assert_logits(want, got, atol):
    """Logits agree within ``atol``; wherever the reference's top-2 margin
    exceeds twice the observed disagreement the greedy picks then agree
    too, so teacher forcing the reference's picks loses nothing."""
    np.testing.assert_allclose(got, want, atol=atol)


def _tiny_torch_cfg(tiny_cfg):
    from repro_torch.configs.base import ModelConfig

    return ModelConfig(**{f: getattr(tiny_cfg, f) for f in (
        "name", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
        "vocab_size", "dtype", "param_dtype")})


@pytest.mark.parametrize("kv", ["none", "q8", "q4"])
@pytest.mark.parametrize("w4a16", [False, True])
def test_prefill_decode_logits_match_reference(tiny_cfg, kv, w4a16):
    jp = japi.get_model(tiny_cfg).init_params(jax.random.key(2), tiny_cfg)
    if w4a16:
        jp = jax_quantize(jp)
    want, got = _run_pair(jp, tiny_cfg, _tiny_torch_cfg(tiny_cfg), kv,
                          seed=4)
    _assert_logits(want, got, ATOL[kv])


@pytest.mark.parametrize("kv", ["none", "q8"])
def test_lut_decode_logits_match_reference(tiny_cfg, kv):
    """The fp16 LUT softmax path against the reference's Pallas kernel
    (kernel_lut, interpret mode)."""
    jp = jax_quantize(japi.get_model(tiny_cfg).init_params(
        jax.random.key(3), tiny_cfg))
    want, got = _run_pair(jp, tiny_cfg, _tiny_torch_cfg(tiny_cfg), kv,
                          lut=True, seed=5)
    _assert_logits(want, got, max(ATOL[kv], 2e-3))


def test_smoke_config_geometry_matches_reference():
    """qwen2.5-1.5b-smoke (Hkv 1, head_dim 8, qkv bias, tied embeddings)
    through fp and q4 pools."""
    cfg_j = jax_get_config("qwen2.5-1.5b", smoke=True)
    cfg_t = get_config("qwen2.5-1.5b", smoke=True)
    assert cfg_t == type(cfg_t)(**{f: getattr(cfg_j, f)
                                   for f in cfg_t.__dataclass_fields__
                                   if f not in ("moe", "ssm")})
    jp = japi.get_model(cfg_j).init_params(jax.random.key(4), cfg_j)
    for kv in ("none", "q4"):
        want, got = _run_pair(jp, cfg_j, cfg_t, kv, seed=6)
        _assert_logits(want, got, ATOL[kv])


def test_bridge_keeps_leaves_byte_for_byte(tiny_cfg):
    jp = jax_quantize(japi.get_model(tiny_cfg).init_params(
        jax.random.key(5), tiny_cfg))
    host = jax.device_get(jp)
    tp = bridge.params_from_jax(host, device="cpu")
    assert len(tp["layers"]) == tiny_cfg.n_layers
    for i in range(tiny_cfg.n_layers):
        for name in ("codes", "scales", "codebook"):
            a = np.asarray(host["layers"]["attn"]["wq"]["w"][name][i])
            b = tp["layers"][i]["attn"]["wq"]["w"][name].numpy()
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    bf = np.asarray(jnp.arange(6, dtype=jnp.bfloat16) / 3)
    t = bridge.to_tensor(bf, "cpu")
    assert t.dtype == torch.bfloat16
    assert t.view(torch.int16).numpy().tobytes() == bf.tobytes()
