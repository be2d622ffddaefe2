"""The port's quantizers against the JAX package's: codes and scales must
be bit-identical on the same weights (both round half to even, take the
first index on argmin ties and round scales to f16 the same way)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.quant import qlinear as JQL
from repro.quant import tile_quant as JTQ
from repro.serving import kv_quant as JKQ
from repro_torch.quant import qlinear as QL
from repro_torch.quant import tile_quant as TQ
from repro_torch.serving import kv_quant as KQ


def _weights(shape, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32) * 0.1
    # exact half-step ties and an all-zero group stress rounding and the
    # 1e-8 scale guard
    w[0, :16] = 0.0
    w[2, :8] = np.float32(0.05)
    return w


@pytest.mark.parametrize("scheme", ["tile", "common"])
@pytest.mark.parametrize("codebook", ["q4_0", "nf4", "fp4", "iq4_nl"])
def test_q4_codes_scales_bit_identical(scheme, codebook):
    w = _weights((64, 96), seed=len(codebook))
    want = JTQ.quantize(jnp.asarray(w), scheme=scheme, codebook=codebook)
    got = TQ.quantize(torch.from_numpy(w), scheme=scheme, codebook=codebook)
    for key in ("codes", "scales", "codebook"):
        assert got[key].numpy().dtype == np.asarray(want[key]).dtype
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
    np.testing.assert_array_equal(
        TQ.dequantize(got).numpy(), np.asarray(JTQ.dequantize(want)))
    assert TQ.infer_scheme(got) == JTQ.infer_scheme(want) == scheme


def test_q8_codes_scales_bit_identical():
    w = _weights((96, 40), seed=3)
    want = JTQ.quantize_q8(jnp.asarray(w))
    got = TQ.quantize_q8(torch.from_numpy(w))
    for key in ("codes", "scales"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
    np.testing.assert_array_equal(TQ.dequantize_q8(got).numpy(),
                                  np.asarray(JTQ.dequantize_q8(want)))


@pytest.mark.parametrize("mode", ["q8", "q4"])
@pytest.mark.parametrize("hkv,d", [(2, 32), (1, 8), (3, 24)])
def test_kv_codes_scales_bit_identical(mode, hkv, d):
    """quantize_kv over (..., Hkv, D) slabs, incl. the gr=1 (odd heads)
    and halved-gc geometries; dequantize_kv must agree bit for bit too."""
    rng = np.random.default_rng(hkv * 100 + d)
    x = rng.standard_normal((3, 5, hkv, d)).astype(np.float32) * 0.7
    x[0, 0] = 0.0  # a scratch-like zero slab
    gr, gc = KQ.kv_tile_geometry(hkv, d)
    assert (gr, gc) == JKQ.kv_tile_geometry(hkv, d)
    want = JKQ.quantize_kv(jnp.asarray(x), mode=mode, gr=gr, gc=gc)
    got = KQ.quantize_kv(torch.from_numpy(x), mode=mode, gr=gr, gc=gc)
    for key in ("codes", "scales"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
    np.testing.assert_array_equal(KQ.dequantize_kv(got).numpy(),
                                  np.asarray(JKQ.dequantize_kv(want)))
    assert KQ.kv_geometry(got)[:3] == JKQ.kv_geometry(want)[:3]


def test_model_policy_matches_reference(tiny_cfg):
    """quantize_model_params applies DEFAULT_POLICY identically: Q4 tile
    for q/k/v/o/gate/up, Q8_0 for down, embeddings and norms untouched."""
    import jax

    from repro.models import api as japi
    from repro_torch import bridge

    jp = japi.get_model(tiny_cfg).init_params(jax.random.key(1), tiny_cfg)
    want = bridge.params_from_jax(jax.device_get(
        JQL.quantize_model_params(jp)), device="cpu")
    got = QL.quantize_model_params(bridge.params_from_jax(
        jax.device_get(jp), device="cpu"))

    def compare(a, b, path=""):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                compare(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                compare(x, y, f"{path}/{i}")
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), path

    compare(got, want)
    layer = got["layers"][0]
    assert "codebook" in layer["attn"]["wq"]["w"]
    assert "codebook" not in layer["ffn"]["down"]["w"]
    assert isinstance(got["embedding"]["table"], torch.Tensor)
