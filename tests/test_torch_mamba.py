"""The port's Mamba2 and zamba2 hybrid (``repro_torch.models.mamba2``)
against the JAX package's ``repro.models.mamba2`` on the CPU, in f32.

The chunked SSD scan (tail padding at S = 13, ngroups 1 and 2, an
initial state), one Mamba2 block in prefill and decode form, and whole
models (mamba2-130m-smoke, zamba2-1.2b-smoke and a small W4A16 hybrid
whose projections tile into Q4 groups) through ``forward``, ``prefill``
into dense rows and teacher-forced ``decode_step``: logits and every
cache leaf (conv, ssm, the shared block's K/V).  Parameters come from the
JAX init, carried across by ``repro_torch.bridge`` (quantized leaves
byte for byte); inputs from numpy seeds.  Each JAX function is jitted
once per config and module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import SSMConfig as JSSMConfig
from repro.models import mamba2 as JM
from repro.quant.qlinear import quantize_model_params as jquantize
from repro_torch import bridge
from repro_torch.configs import registry as R
from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.models import api
from repro_torch.models import mamba2 as M

# f32 on both sides, summed in other orders: the scan and one block agree
# to ~1e-7 (1e-5 stated); whole models through 2-5 layers, the shared
# block and a 512-way head to ~1e-6 (1e-5 stated)
ATOL = 1e-5
MAX_LEN = 32


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return bridge.to_tensor(np.asarray(tree), "cpu")


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, what, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0,
                               err_msg=what)


def _cfg_pair(G: int, chunk: int = 8):
    """(JAX cfg, port cfg) of a small pure Mamba2 block with ``G`` groups:
    d_model 32, 8 heads of 8, d_state 6."""
    kw = dict(name="ssm", family="mamba2", n_layers=2, d_model=32,
              n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=64,
              dtype="float32")
    ssm = dict(d_state=6, head_dim=8, expand=2, conv_width=4,
               chunk_size=chunk, ngroups=G)
    return (JModelConfig(**kw, ssm=JSSMConfig(**ssm)),
            ModelConfig(**kw, ssm=SSMConfig(**ssm)))


# ---------------------------------------------------------------------------
# the scan and one block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [16, 13])
@pytest.mark.parametrize("G", [1, 2])
def test_ssd_chunked_matches_reference(S, G):
    """y and the final state at a whole number of chunks (16 = 2 x 8) and
    with a padded tail (13), with no initial state and with one."""
    jcfg, cfg = _cfg_pair(G)
    rng = np.random.default_rng(S * 10 + G)
    B, H, P, N = 2, 8, 8, 6
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(0.5 * rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    h0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    ssd = jax.jit(JM._ssd_chunked, static_argnums=5)
    for init in (None, h0):
        want_y, want_h = ssd(
            *map(jnp.asarray, (x, dt, A, Bm, Cm)), jcfg,
            initial_state=None if init is None else jnp.asarray(init))
        got_y, got_h = M._ssd_chunked(
            *map(torch.from_numpy, (x, dt, A, Bm, Cm)), cfg,
            initial_state=None if init is None else torch.from_numpy(init))
        assert got_y.shape == (B, S, H, P) and got_h.dtype == torch.float32
        _close(got_y, want_y, f"y S{S} G{G}")
        _close(got_h, want_h, f"state S{S} G{G}")


@pytest.mark.parametrize("G", [1, 2])
def test_mamba_layer_and_decode_step_match_reference(G):
    """One block over a 13-token sequence (the conv state is its last 3
    raw inputs), then 3 recurrent steps from that state."""
    jcfg, cfg = _cfg_pair(G)
    jp = JM.init_mamba_layer(jax.random.key(G), jcfg, jnp.float32)
    tp = _torch(jax.device_get(jp))
    rng = np.random.default_rng(G)
    x = rng.standard_normal((2, 13, 32)).astype(np.float32)
    layer = jax.jit(JM.mamba_layer, static_argnums=2)
    step = jax.jit(JM.mamba_decode_step, static_argnums=3)
    want, (jconv, jssm) = layer(jp, jnp.asarray(x), jcfg)
    got, (conv, ssm) = M.mamba_layer(tp, torch.from_numpy(x), cfg)
    _close(got, want, "layer out")
    _close(conv, jconv, "conv state")
    _close(ssm, jssm, "ssm state")
    jstate, state = (jconv, jssm), (conv, ssm)
    for t in range(3):
        xt = rng.standard_normal((2, 1, 32)).astype(np.float32)
        want, jstate = step(jp, jnp.asarray(xt), jstate, jcfg)
        got, state = M.mamba_decode_step(tp, torch.from_numpy(xt), state, cfg)
        _close(got, want, f"decode out {t}")
        _close(state[0], jstate[0], f"decode conv {t}")
        _close(state[1], jstate[1], f"decode ssm {t}")


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


def w4_hybrid_cfgs():
    """(JAX cfg, port cfg) of a small zamba2-style hybrid whose every
    projection tiles into (2, 16) Q4 groups: in_proj 64 -> 2*128 + 2*24 +
    16 = 320, out_proj 128 -> 64, q/k/v/o 64 -> 64, gate/up 64 -> 128."""
    kw = dict(name="hybrid-w4", family="hybrid", n_layers=4, d_model=64,
              n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
              vocab_size=320, hybrid_attn_every=2, dtype="float32")
    ssm = dict(d_state=24, head_dim=8, expand=2, conv_width=4, chunk_size=8)
    return (JModelConfig(**kw, ssm=JSSMConfig(**ssm)),
            ModelConfig(**kw, ssm=SSMConfig(**ssm)))


MODELS = ("mamba2-130m", "zamba2-1.2b", "hybrid-w4")


@pytest.fixture(scope="module")
def model():
    """arch -> (JAX cfg, port cfg, JAX params, port params, jitted JAX
    forward / prefill / decode, the port's copy of the JAX f32 params
    before quantization), built once per module."""
    made = {}

    def make(arch):
        if arch in made:
            return made[arch]
        if arch == "hybrid-w4":
            jcfg, cfg = w4_hybrid_cfgs()
        else:
            jcfg, cfg = (JR.get_config(arch, smoke=True),
                         R.get_config(arch, smoke=True))
        jp = jax.jit(lambda k: JM.init_params(k, jcfg))(jax.random.key(3))
        fp = bridge.params_from_jax(jax.device_get(jp), device="cpu")
        if arch == "hybrid-w4":
            jp = jax.jit(jquantize)(jp)
        tp = bridge.params_from_jax(jax.device_get(jp), device="cpu")
        fns = (jax.jit(lambda p, t: JM.forward(p, t, jcfg)[0]),
               jax.jit(lambda p, t, n: JM.prefill(p, t, jcfg,
                                                   max_len=MAX_LEN,
                                                   lengths=n)),
               jax.jit(lambda p, t, c, n: JM.decode_step(p, t, c, n, jcfg)))
        made[arch] = (jcfg, cfg, jp, tp, fns, fp)
        return made[arch]

    return make


def test_configs_route_to_the_mamba2_module():
    for arch in ("mamba2-130m", "zamba2-1.2b"):
        for smoke in (False, True):
            cfg = R.get_config(arch, smoke=smoke)
            assert dataclasses.asdict(cfg) == dataclasses.asdict(
                JR.get_config(arch, smoke=smoke))
            assert api.get_model(cfg) is M
    assert api.get_model(w4_hybrid_cfgs()[1]) is M


@pytest.mark.parametrize("arch", MODELS)
def test_forward_prefill_decode_match_reference(model, arch):
    """Full-sequence logits; prefill of ragged prompts (lengths 11 and 7
    in a width of 11: the shorter row's state holds its pads, as in the
    reference) into dense rows, its logits at each row's last position
    and every cache leaf; then 5 teacher-forced decode steps, logits and
    every leaf after each."""
    jcfg, cfg, jp, tp, (jfwd, jprefill, jdecode), _ = model(arch)
    if arch == "hybrid-w4":
        w = tp["layers"][0]["in_proj"]["w"]
        assert w["codes"].shape == (64, 160)          # Q4: N 320 packed
        assert tp["shared_attn"]["ffn"]["down"]["w"]["codes"].dtype == \
            torch.int8                                # Q8 FFN down
        assert tp["layers"][0]["A_log"].dtype == torch.float32
    rng = np.random.default_rng(len(arch))
    toks = rng.integers(3, 300, (2, 11)).astype(np.int32)
    lens = np.array([11, 7], np.int32)
    forced = rng.integers(3, 300, (2, 5)).astype(np.int32)

    want, _ = jfwd(jp, jnp.asarray(toks)), None
    got, _ = M.forward(tp, torch.from_numpy(toks), cfg)
    _close(got, want, "forward logits")

    jlog, jcache = jprefill(jp, jnp.asarray(toks), jnp.asarray(lens))
    cache = M.init_cache(cfg, 2, MAX_LEN, device="cpu")
    assert set(cache) == set(jcache)
    for name, leaf in cache.items():
        assert leaf.shape == jcache[name].shape, name
        assert leaf.dtype == (torch.float32), name
    logits = M.prefill(tp, torch.from_numpy(toks), cfg,
                       lengths=torch.from_numpy(lens), cache=cache)
    _close(logits, jlog, "prefill logits")
    for name in cache:
        _close(cache[name], jcache[name], f"prefill {name}")
    clen = lens.copy()
    for t in range(forced.shape[1]):
        clen = clen + 1
        jlog, jcache = jdecode(jp, jnp.asarray(forced[:, t:t + 1]), jcache,
                               jnp.asarray(clen))
        logits = M.decode_step(tp, torch.from_numpy(forced[:, t:t + 1]),
                               cache, torch.from_numpy(clen), cfg)
        _close(logits, jlog, f"decode logits {t}")
        for name in cache:
            _close(cache[name], jcache[name], f"decode {t} {name}")


def test_quantize_and_cast_walk_the_hybrid_tree_as_the_reference(model):
    """``quantize_model_params`` on the port's copy of the JAX f32 hybrid
    tree gives the JAX quantizer's tree byte for byte (Q4 in_proj /
    out_proj and shared q/k/v/o/gate/up, Q8 FFN down, A_log / dt_bias /
    D / conv / norms fp), and ``cast_params`` leaves the SSM's f32
    parameters (A_log, dt_bias, D) and the norms in f32."""
    from repro_torch.quant.qlinear import cast_params, quantize_model_params

    *_, tp, _, fp = model("hybrid-w4")
    got = quantize_model_params(fp)

    def walk(a, b, path):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}/{i}")
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), path

    walk(got, tp, "")
    lp = got["layers"][0]
    assert set(lp["in_proj"]["w"]) == {"codes", "scales", "codebook"}
    assert set(got["shared_attn"]["ffn"]["down"]["w"]) == {"codes",
                                                          "scales"}
    cast = cast_params(got, torch.bfloat16)["layers"][0]
    for name in ("A_log", "dt_bias", "D"):
        assert cast[name].dtype == torch.float32, name
    assert cast["norm"]["scale"].dtype == torch.float32
    assert cast["conv"]["w"].dtype == cast["conv"]["b"].dtype == \
        torch.bfloat16
    assert cast["in_proj"]["w"]["codes"].dtype == torch.uint8


def test_init_params_distributions_and_layout():
    """The port's own init: the JAX tree's structure and shapes, the fixed
    SSM parameters (A_log 0, dt_bias -2, D 1, zero conv bias), a seeded
    generator (same seed, same numbers), and a conv weight of std
    ~1/sqrt(W); a transformer config is refused."""
    jcfg = JR.get_config("zamba2-1.2b", smoke=True)
    cfg = R.get_config("zamba2-1.2b", smoke=True)
    want = jax.eval_shape(lambda: JM.init_params(jax.random.key(0), jcfg))
    got = M.init_params(cfg, seed=5, device="cpu")
    again = M.init_params(cfg, seed=5, device="cpu")
    layer = jax.tree.map(lambda a: a.shape[1:], want["layers"])
    for lp in got["layers"]:
        assert jax.tree.map(lambda a: tuple(a.shape), lp) == layer
    top = {k: v for k, v in want.items() if k != "layers"}
    assert jax.tree.map(lambda a: a.shape, top) == jax.tree.map(
        lambda a: tuple(a.shape), {k: v for k, v in got.items()
                                   if k != "layers"})
    lp = got["layers"][0]
    assert torch.equal(lp["A_log"], torch.zeros(8))
    assert torch.equal(lp["dt_bias"], torch.full((8,), -2.0))
    assert torch.equal(lp["D"], torch.ones(8))
    assert not lp["conv"]["b"].any()
    assert torch.equal(lp["in_proj"]["w"], again["layers"][0]["in_proj"]["w"])
    stds = torch.stack([p["conv"]["w"].std() for p in got["layers"]])
    assert 0.35 < float(stds.mean()) < 0.65         # 1/sqrt(4) = 0.5
    with pytest.raises(ValueError, match="mamba2"):
        M.init_params(R.get_config("qwen2.5-1.5b", smoke=True), device="cpu")


def test_prefill_refuses_modality_embeddings(model):
    """``embeddings=`` is taken and ignored, as the reference's
    ``forward`` takes it (the family has no modality frontend): prefill
    with the argument gives the logits and every cache leaf of prefill
    without it, bit for bit, and the logits of the reference's
    ``forward`` given the same embeddings."""
    jcfg, cfg, jp, tp, _, _ = model("mamba2-130m")
    rng = np.random.default_rng(23)
    toks = rng.integers(3, 300, (2, 6)).astype(np.int32)
    emb = rng.standard_normal((2, 3, cfg.d_model)).astype(np.float32)
    lens = torch.tensor([6, 6], dtype=torch.int32)
    runs = []
    for kw in ({}, {"embeddings": torch.from_numpy(emb)}):
        cache = M.init_cache(cfg, 2, 8, device="cpu")
        logits = M.prefill(tp, torch.from_numpy(toks), cfg, lengths=lens,
                           cache=cache, **kw)
        runs.append((logits, cache))
    (plain, pc), (got, gc) = runs
    assert torch.equal(got, plain)
    for name in pc:
        assert torch.equal(gc[name], pc[name]), name
    jfwd = jax.jit(lambda p, t, e: JM.forward(p, t, jcfg, embeddings=e)[0])
    want = jfwd(jp, jnp.asarray(toks), jnp.asarray(emb))[:, -1]
    _close(got, want, "prefill logits vs forward(embeddings=)")
