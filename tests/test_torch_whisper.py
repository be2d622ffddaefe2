"""The port's Whisper encoder-decoder against the JAX package's, on the
same bridged params and seeded numpy inputs, f32 on both sides.

The building blocks (layernorm, the tanh-GELU MLP, the encoder's
sinusoids) within 1e-6; at whisper-base-smoke, ``encode``, ``forward``,
``prefill`` into dense rows and teacher-forced ``decode_step`` within
1e-5 on every logit and every cache leaf (self and cross K/V); the
encoder at 1100 frames, past the JAX package's 1024-wide KV chunk; the
W4A16 tree byte for byte; the dense ``DecodeEngine`` (prefill over
frames, fork, greedy generate) token for token, fp and W4A16; and
``serve.py``'s refusal of whisper-base.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import layers as JL
from repro.models import whisper as JW
from repro.quant.qlinear import quantize_model_params as jquantize
from repro.serving.engine import DecodeEngine as JEngine
from repro.serving.sampler import SamplerConfig as JSampler
from repro_torch import bridge
from repro_torch.configs import registry as R
from repro_torch.models import layers as L
from repro_torch.models import whisper as W
from repro_torch.quant.qlinear import quantize_model_params
from repro_torch.serving.engine import DecodeEngine
from repro_torch.serving.sampler import SamplerConfig

ATOL = 1e-5       # f32 both sides, summed in other orders
BLOCK_ATOL = 1e-6
B, S, MAX_LEN = 2, 7, 32


def _np(x):
    return np.asarray(x.detach()) if torch.is_tensor(x) else np.asarray(x)


# the reference's functions, jitted once per module (eager JAX compiles
# op by op)
J_ENCODE = jax.jit(JW.encode, static_argnums=2)
J_FORWARD = jax.jit(lambda p, t, f, cfg: JW.forward(p, t, cfg, frames=f)[0],
                    static_argnums=3)
J_PREFILL = jax.jit(lambda p, t, f, n, cfg: JW.prefill(
    p, t, cfg, max_len=MAX_LEN, frames=f, lengths=n), static_argnums=4)
J_DECODE = jax.jit(JW.decode_step, static_argnums=4)
J_QUANTIZE = jax.jit(jquantize)


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, JAX-layout params, port cfg, port params, inputs) at
    smoke size: the port's seeded init, stacked for the reference by
    ``bridge.params_to_jax``."""
    cfg = JR.get_config("whisper-base", smoke=True)
    tcfg = R.get_config("whisper-base", smoke=True)
    tp = W.init_params(tcfg, seed=3, device="cpu")
    jp = jax.tree.map(jnp.asarray, bridge.params_to_jax(tp))
    rng = np.random.default_rng(0)
    inp = {"toks": rng.integers(3, 500, (B, S)).astype(np.int32),
           "lens": np.array([S, 4], np.int32),
           "frames": rng.standard_normal(
               (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32),
           "forced": rng.integers(3, 500, (B, 5)).astype(np.int32)}
    return cfg, jp, tcfg, tp, inp


@pytest.mark.parametrize("block", ["layernorm", "mlp", "sinusoids"])
def test_building_blocks_match(model, block):
    cfg, jp, _, tp, inp = model
    x = np.random.default_rng(1).standard_normal((B, S, 64)).astype(
        np.float32) * 3 + 0.5
    if block == "layernorm":
        p = {"scale": np.linspace(0.5, 1.5, 64, dtype=np.float32),
             "bias": np.linspace(-0.2, 0.3, 64, dtype=np.float32)}
        want = JL.layernorm(p, jnp.asarray(x))
        got = L.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x))
    elif block == "mlp":
        want = JL.mlp(jax.tree.map(lambda a: a[0], jp["dec_layers"]["mlp"]),
                      jnp.asarray(x))
        got = L.mlp(tp["dec_layers"][0]["mlp"], torch.from_numpy(x))
    else:
        # the two exp implementations round a frequency differently in
        # its last f32 bit (one ulp of a value <= 1: 2^-23), which the
        # angle t x freq carries multiplied by the position t
        for n, d in ((24, 64), (1500, 512)):
            t = np.arange(n, dtype=np.float64)[:, None]
            err = np.abs(_np(W._sinusoids(n, d)) - _np(JW._sinusoids(n, d)))
            assert (err <= BLOCK_ATOL + t * 2.0 ** -23).all(), err.max()
        return
    np.testing.assert_allclose(_np(got), _np(want), atol=BLOCK_ATOL,
                               rtol=0)


def test_encode_and_forward_match(model):
    cfg, jp, tcfg, tp, inp = model
    fr = inp["frames"]
    np.testing.assert_allclose(
        _np(W.encode(tp, torch.from_numpy(fr), tcfg)),
        _np(J_ENCODE(jp, jnp.asarray(fr), cfg)), atol=ATOL, rtol=0)
    want = J_FORWARD(jp, jnp.asarray(inp["toks"]), jnp.asarray(fr), cfg)
    got, (kvs, cross), aux = W.forward(
        tp, torch.from_numpy(inp["toks"]), tcfg,
        embeddings=torch.from_numpy(fr), return_kv=True, return_aux=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)
    assert float(aux) == 0.0 and len(kvs) == len(cross) == cfg.n_layers


def test_prefill_and_teacher_forced_decode_match(model):
    """Ragged prompts prefilled into dense rows (cross K/V included),
    then 5 teacher-forced decode steps: every step's logits and, after
    the last, every cache leaf."""
    cfg, jp, tcfg, tp, inp = model
    jlog, jc = J_PREFILL(jp, jnp.asarray(inp["toks"]),
                         jnp.asarray(inp["frames"]), jnp.asarray(inp["lens"]),
                         cfg)
    cache = W.init_cache(tcfg, B, MAX_LEN, t_enc=cfg.encoder_seq_len,
                         device="cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}
    tlog = W.prefill(tp, torch.from_numpy(inp["toks"]), tcfg,
                     lengths=torch.from_numpy(inp["lens"]), cache=cache,
                     embeddings=torch.from_numpy(inp["frames"]))
    want, got = [_np(jlog)], [_np(tlog)]
    jlen, tlen = jnp.asarray(inp["lens"]), torch.from_numpy(inp["lens"])
    for t in range(inp["forced"].shape[1]):
        x = inp["forced"][:, t:t + 1]
        jlen, tlen = jlen + 1, tlen + 1
        jlog, jc = J_DECODE(jp, jnp.asarray(x), jc, jlen, cfg)
        want.append(_np(jlog))
        got.append(_np(W.decode_step(tp, torch.from_numpy(x), cache, tlen,
                                     tcfg)))
    np.testing.assert_allclose(np.stack(got), np.stack(want), atol=ATOL,
                               rtol=0)
    for name in ("k", "v", "cross_k", "cross_v"):
        np.testing.assert_allclose(_np(cache[name]), _np(jc[name]),
                                   atol=ATOL, rtol=0, err_msg=name)


def test_encoder_past_one_kv_chunk(model, monkeypatch):
    """1100 frames: the JAX encoder scans three q chunks of 512 and two
    KV chunks of 1024 (padded, masked); the port attends in one chunk.
    Both sides read one sinusoid table (f64, rounded to f32) here: past a
    few hundred positions the two exp implementations' last-bit
    difference in a frequency moves the angle by more than the attention
    tolerance (``test_building_blocks_match[sinusoids]``)."""
    cfg, jp, tcfg, tp, _ = model

    def table(length, d, device=None):
        half = d // 2
        freq = np.exp(-np.log(10000.0) * np.arange(half) / (half - 1))
        ang = np.arange(length)[:, None] * freq[None]
        return np.concatenate([np.sin(ang), np.cos(ang)], -1).astype(
            np.float32)

    monkeypatch.setattr(JW, "_sinusoids",
                        lambda n, d: jnp.asarray(table(n, d)))
    monkeypatch.setattr(W, "_sinusoids", lambda n, d, device=None:
                        torch.from_numpy(table(n, d)).to(device))
    fr = np.random.default_rng(5).standard_normal(
        (1, 1100, cfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(
        _np(W.encode(tp, torch.from_numpy(fr), tcfg)),
        _np(JW.encode(jp, jnp.asarray(fr), cfg)), atol=ATOL, rtol=0)


def test_quantized_tree_is_the_reference_byte_for_byte(model):
    """W4A16 under DEFAULT_POLICY (Q4 q/k/v/o and fc1, Q8 fc2, the
    ``frame_proj`` stub, embeddings and norms left fp)."""
    _, jp, _, tp, _ = model
    want = bridge.params_from_jax(jax.device_get(J_QUANTIZE(jp)),
                                  device="cpu")
    got = quantize_model_params(tp)

    def walk(a, b, path=""):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}/{i}")
        else:
            assert a.dtype == b.dtype and a.shape == b.shape, path
            assert torch.equal(a, b), path

    walk(got, want)
    assert "codebook" in got["enc_layers"][0]["attn"]["wq"]["w"]
    assert "codebook" not in got["dec_layers"][1]["mlp"]["fc2"]["w"]
    assert torch.is_tensor(got["frame_proj"]["w"])


@pytest.mark.parametrize("weights", ["fp", "w4a16"])
def test_dense_engine_prefill_fork_generate_tokens(model, weights):
    """The JAX package's Whisper serving path: ``prefill(tokens, lengths,
    embeddings=frames)`` on dense rows (20 frames, so the cross rows take
    the frames' length, not the config's 24), ``fork`` x 2, greedy
    ``generate``: tokens equal row for row, the cross K/V carried by the
    fork."""
    cfg, jp, tcfg, tp, inp = model
    if weights == "w4a16":
        tp = quantize_model_params(tp)
        jp = J_QUANTIZE(jp)
    fr = inp["frames"][:, :20]
    kw = dict(max_len=MAX_LEN, eos_id=2, pad_id=0)
    jeng, teng = JEngine(jp, cfg, **kw), DecodeEngine(tp, tcfg, **kw)
    js = jeng.fork(jeng.prefill(jnp.asarray(inp["toks"]),
                                jnp.asarray(inp["lens"]), jnp.asarray(fr)),
                   2)
    ts = teng.fork(teng.prefill(torch.from_numpy(inp["toks"]),
                                torch.from_numpy(inp["lens"]),
                                torch.from_numpy(fr)), 2)
    assert tuple(ts.cache["cross_k"].shape) == (cfg.n_layers, 2 * B, 20,
                                                cfg.n_kv_heads, 16)
    _, jt = jeng.generate(js, 10, jax.random.key(0), JSampler(greedy=True),
                          stop_ids=(9999,))
    _, tt = teng.generate(ts, 10, None, SamplerConfig(greedy=True),
                          stop_ids=(9999,))
    np.testing.assert_array_equal(_np(tt), _np(jt))


def test_serve_refuses_whisper_before_building():
    from repro_torch.launch import serve

    with pytest.raises(ValueError, match="frames"):
        serve.main(["--arch", "whisper-base", "--smoke", "--device", "cpu",
                    "--dry"])
