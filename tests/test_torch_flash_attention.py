"""K5 in the port against the JAX package: ``ops.flash_attention`` and the
raw ``lut_softmax_attention`` wrapper on the same numpy inputs as the JAX
package's (its Pallas kernel in interpret mode), in all three exp modes.
On the CPU the port's wrapper runs its plain version; the CUDA kernel is
held against that plain version in ``test_torch_cuda.py`` and
``chip_smoke.py``."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import autotune as jautotune
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.lut_softmax_attention import _poly_exp
from repro.kernels.lut_softmax_attention import build_exp_lut as jax_lut
from repro.kernels.lut_softmax_attention import \
    lut_softmax_attention as jax_kernel
from repro_torch.kernels import autotune, ops, ref
from repro_torch.kernels import lut_softmax_attention as K5

ATOL = 2e-3  # the JAX package's kernel-vs-oracle bar (tests/test_kernels.py)
MODES = ("lut", "poly", "exact")
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def analytic_autotune(tmp_path, monkeypatch):
    """The JAX wrapper's block choice from its analytic model alone: no
    measured cache file."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "none.json"))
    jautotune.reset()
    yield
    jautotune.reset()


def _qkv(B, Sq, Skv, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, Sq, Hq, D)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, Skv, Hkv, D)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((B, Skv, Hkv, D)) * 0.5).astype(np.float32)
    return q, k, v


def _both(q, k, v, **kw):
    """(JAX ops.flash_attention, port ops.flash_attention) as f32 numpy."""
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), **kw)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    return np.asarray(want, np.float32), got.numpy()


# (B, Sq, Skv, Hq, Hkv, D): the JAX package's own kernel test shapes
SHAPES = [(2, 128, 128, 4, 2, 64), (1, 256, 256, 8, 8, 32),
          (2, 128, 384, 4, 1, 64)]


@pytest.mark.parametrize("exp_mode", MODES)
@pytest.mark.parametrize("shape", SHAPES)
def test_flash_attention_matches_jax(shape, exp_mode):
    q, k, v = _qkv(*shape, seed=sum(shape))
    causal = shape[1] == shape[2]
    before = K5.lut_softmax_attention.launches
    want, got = _both(q, k, v, causal=causal, exp_mode=exp_mode)
    assert K5.lut_softmax_attention.launches == before  # CPU: plain version
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("exp_mode", MODES)
def test_flash_attention_ragged_length_matches_jax(exp_mode):
    """S = 79 (the serve runs' cold prefill length) is prime: one 79-row
    block each way."""
    q, k, v = _qkv(1, 79, 79, 4, 2, 32, seed=79)
    assert autotune.pick_block(79, 128) == 79
    want, got = _both(q, k, v, causal=True, exp_mode=exp_mode)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_kv_block_length_is_part_of_the_function():
    """The raw kernel at bkv 64 and 128 on one input: each agrees with the
    JAX kernel at the same bkv, and the two differ (the fp16 running max
    is rounded once per block)."""
    rng = np.random.default_rng(5)
    q, k, v = ((rng.standard_normal((4, 256, 32)) * 0.5).astype(np.float16)
               for _ in range(3))
    outs = {}
    for bkv in (64, 128):
        want = np.asarray(jax_kernel(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jax_lut(),
            causal=True, bq=128, bkv=bkv, exp_mode="lut"), np.float32)
        got = K5.lut_softmax_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            ops.exp_lut(), causal=True, bq=128, bkv=bkv, exp_mode="lut")
        assert got.dtype == torch.float16
        np.testing.assert_allclose(got.float().numpy(), want, atol=ATOL,
                                   rtol=0)
        outs[bkv] = got
    assert not torch.equal(outs[64], outs[128])


def test_raw_kernel_gqa_indexes_kv_heads():
    """kv_group G: query head bh reads KV head bh // G, as the JAX kernel
    does on repeated K/V."""
    rng = np.random.default_rng(6)
    q = (rng.standard_normal((6, 64, 32)) * 0.5).astype(np.float16)
    k, v = ((rng.standard_normal((2, 64, 32)) * 0.5).astype(np.float16)
            for _ in range(2))
    want = np.asarray(jax_kernel(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), 3, axis=0),
        jnp.repeat(jnp.asarray(v), 3, axis=0), jax_lut(), causal=False,
        bq=32, bkv=32, exp_mode="poly"), np.float32)
    got = K5.lut_softmax_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), None,
        causal=False, bq=32, bkv=32, exp_mode="poly", kv_group=3)
    np.testing.assert_allclose(got.float().numpy(), want, atol=ATOL, rtol=0)


def test_flash_attention_bf16_in_bf16_out():
    q, k, v = _qkv(1, 128, 128, 4, 2, 64, seed=11)
    to_bf16 = lambda x: x.astype(jnp.bfloat16)
    want = jops.flash_attention(*map(to_bf16, map(jnp.asarray, (q, k, v))),
                                causal=True, exp_mode="lut")
    got = ops.flash_attention(*(torch.from_numpy(x).bfloat16()
                                for x in (q, k, v)),
                              causal=True, exp_mode="lut")
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    # the kernel bar plus one bf16 rounding step: both sides round their
    # fp16 output to bf16
    np.testing.assert_allclose(got.float().numpy(), want, atol=ATOL,
                               rtol=2.0 ** -7)


def test_block_sizes_must_divide():
    q = torch.zeros((1, 12, 64), dtype=torch.float16)
    with pytest.raises(ValueError, match=r"Sq=12 with bq=8"):
        K5.lut_softmax_attention(q, q, q, ops.exp_lut(), bq=8, bkv=4)
    with pytest.raises(ValueError, match="exp_mode"):
        K5.lut_softmax_attention(q, q, q, ops.exp_lut(), exp_mode="fast")


def test_table5_lut_attention_is_close_to_f32():
    """Paper Table 5: LUT-fp16 attention within 2e-2 of f32 attention; the
    port's f32 yardstick equals the JAX package's."""
    B, S, H, D = 2, 256, 4, 64
    q, k, v = _qkv(B, S, S, H, H, D, seed=2)
    o = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                            exp_mode="lut")
    bh = lambda x: torch.from_numpy(x).transpose(1, 2).reshape(B * H, S, D)
    o32 = ref.attention_f32_ref(bh(q), bh(k), bh(v), causal=True)
    want32 = jref.attention_f32_ref(*(jnp.asarray(bh(x).numpy())
                                      for x in (q, k, v)), causal=True)
    np.testing.assert_allclose(o32.numpy(), np.asarray(want32), atol=1e-5)
    o32 = o32.reshape(B, H, S, D).transpose(1, 2)
    assert float((o - o32).abs().max()) < 2e-2


def test_poly_exp_bitwise_matches_jax():
    """Every finite fp16 x <= 0: the same f32 floor, Horner steps and
    ldexp, bit for bit."""
    bits = np.concatenate([np.arange(0x8000, 0xFC00), [0]]).astype(
        np.uint16)
    x = bits.view(np.float16)
    want = np.asarray(_poly_exp(jnp.asarray(x)))
    got = ref.poly_exp(torch.from_numpy(x.copy())).numpy()
    assert got.view(np.uint16).tolist() == want.view(np.uint16).tolist()


def _chip_smoke_cases():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FLASH_CASES


def test_pick_block_matches_jax_attn_blocks():
    """The port's blocks equal the JAX wrapper's analytic pick at every
    shape this file and chip_smoke.py run."""
    shapes = [(B * Hq, Sq, Skv, D) for B, Sq, Skv, Hq, _, D in SHAPES]
    shapes.append((4, 79, 79, 32))
    shapes += [(c["B"] * c["Hq"], c["Sq"], c["Skv"], c["D"])
               for c in _chip_smoke_cases()]
    assert len(shapes) >= 10
    for BH, Sq, Skv, D in shapes:
        want = jautotune.attn_blocks(BH, Sq, Skv, D)
        assert (autotune.pick_block(Sq, 128),
                autotune.pick_block(Skv, 128)) == tuple(want), (BH, Sq, Skv)


def test_pick_block_contract():
    with pytest.raises(ValueError, match="multiple of 16"):
        autotune.pick_block(24, 256, multiple_of=16)
    assert autotune.pick_block(256, 128) == 128
    assert autotune.pick_block(48, 32, 16) == 16
    assert autotune.pick_block(7, 4) == 7
    for args in [(12, 8), (2048, 128), (79, 128), (384, 128, 2)]:
        assert autotune.pick_block(*args) == jautotune.pick_block(*args)
    assert autotune.attn_cost(8, 128, 256, 64) == \
        jautotune.attn_cost(8, 128, 256, 64)
    assert autotune.quantize_cost(1536, 256) == \
        jautotune.quantize_cost(1536, 256)
