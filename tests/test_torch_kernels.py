"""The port's kernel plain versions against the JAX package's Pallas kernels
(interpret mode), on the same numpy inputs.  The CUDA kernels against
these plain versions: ``test_torch_cuda.py`` and ``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import lut_dequant_gemm as JG
from repro.kernels import ops as jops
from repro.kernels.lut_softmax_attention import build_exp_lut as jax_lut
from repro.quant import tile_quant as JTQ
from repro.serving import kv_quant as JKQ
from repro_torch.kernels import lut_dequant_gemm as G
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as PA

ATOL = {"exact": 2e-5, "lut": 2e-3}   # the reference's own kernel bars


def _paged_inputs(shape, kind, seed):
    """Ragged paged-decode case as numpy: row 1 has length 0, row 0 is full;
    pools fp or JAX-quantized {"codes", "scales"}."""
    B, nb, bs, Hkv, G_, W, D = shape
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, Hkv, G_, D)) * 0.5).astype(np.float32)
    pools = []
    for _ in range(2):
        fp = (rng.standard_normal((nb, bs, Hkv, D)) * 0.5).astype(np.float32)
        if kind == "fp":
            pools.append(fp)
        else:
            gr, gc = JKQ.kv_tile_geometry(Hkv, D)
            qd = JKQ.quantize_kv(jnp.asarray(fp), mode=kind, gr=gr, gc=gc)
            pools.append({k: np.asarray(v) for k, v in qd.items()})
    lens = rng.integers(1, W * bs + 1, size=B).astype(np.int32)
    lens[0], lens[1] = W * bs, 0
    table = np.zeros((B, W), np.int32)
    avail = list(range(1, nb))
    for b in range(B):
        n = -(-int(lens[b]) // bs)
        table[b, :n] = [avail.pop(rng.integers(len(avail))) for _ in range(n)]
    return q, pools[0], pools[1], table, lens


def _t(x):
    if isinstance(x, dict):
        return {k: torch.from_numpy(np.array(v)) for k, v in x.items()}
    return torch.from_numpy(np.array(x))


SHAPE_A = (3, 14, 4, 2, 4, 6, 32)   # Hkv 2, D 32: (2, 16) KV tiles
SHAPE_B = (2, 10, 4, 1, 6, 4, 8)    # Hkv 1, D 8: gr 1, gc 8 fallbacks


@pytest.mark.parametrize("kind", ["fp", "q8", "q4"])
@pytest.mark.parametrize("exp_mode", ["exact", "lut"])
@pytest.mark.parametrize("shape,window,softcap", [
    (SHAPE_A, 0, 0.0), (SHAPE_A, 6, 30.0), (SHAPE_B, 5, 0.0)])
def test_paged_attention_plain_matches_jax_kernel(kind, exp_mode, shape,
                                                  window, softcap):
    """K1 (fp pools) and K2 (q8/q4 pools): window, softcap, a zero-length
    row and the Hkv=1 / head_dim=8 geometry, exact and LUT softmax."""
    B, nb, bs, Hkv, G_, W, D = shape
    q, kp, vp, table, lens = _paged_inputs(shape, kind, seed=B * 10 + D)
    jkp = kp if kind == "fp" else {k: jnp.asarray(v) for k, v in kp.items()}
    jvp = vp if kind == "fp" else {k: jnp.asarray(v) for k, v in vp.items()}
    want = jops.paged_flash_decode(
        jnp.asarray(q).reshape(B, 1, Hkv * G_, D), jkp, jvp, table, lens,
        window=window, softcap=softcap, exp_mode=exp_mode)
    want = np.asarray(want).reshape(B, Hkv, G_, D)
    wrapper = PA.paged_attention if kind == "fp" else PA.quant_paged_attention
    got = wrapper(_t(q), _t(kp), _t(vp), _t(table), _t(lens),
                  ops.exp_lut() if exp_mode == "lut" else None,
                  window=window, softcap=softcap, exp_mode=exp_mode)
    assert got.dtype == torch.float32 and got.shape == (B, Hkv, G_, D)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL[exp_mode])
    assert float(got[1].abs().max()) == 0.0  # zero-length row is exactly 0


def test_paged_decode_dispatch_matches_wrapper():
    """``ops.paged_flash_decode`` (the model's entry) reshapes the model's
    (B, 1, Hq, D) query into the wrapper's (B, Hkv, G, D) grouping."""
    B, nb, bs, Hkv, G_, W, D = SHAPE_A
    q, kp, vp, table, lens = _paged_inputs(SHAPE_A, "q8", seed=5)
    got = ops.paged_flash_decode(_t(q).reshape(B, 1, Hkv * G_, D), _t(kp),
                                 _t(vp), _t(table), _t(lens),
                                 exp_mode="lut")
    want = PA.quant_paged_attention(_t(q), _t(kp), _t(vp), _t(table),
                                    _t(lens), ops.exp_lut(), exp_mode="lut")
    assert torch.equal(got.reshape(B, Hkv, G_, D), want)


def test_exp_lut_identical_to_jax():
    np.testing.assert_array_equal(ref.build_exp_lut().numpy(),
                                  np.asarray(jax_lut()))


@pytest.mark.parametrize("scheme", ["tile", "common"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-3),
                                       ("bfloat16", 2e-2)])
def test_lut_dequant_gemm_plain_matches_jax_kernel(scheme, dtype, tol):
    """K3: x @ dequant(codes, scales, codebook), weight rounded to x's
    dtype, f32 accumulation, ragged M (not a tile multiple)."""
    M, K, N = 20, 128, 96
    rng = np.random.default_rng(len(scheme) * 10 + len(dtype))
    w = (rng.standard_normal((K, N)) * 0.1).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    qw = JTQ.quantize(jnp.asarray(w), scheme=scheme)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = JG.lut_dequant_gemm(jx, qw["codes"], qw["scales"],
                               qw["codebook"], scheme=scheme, bm=M, bn=N,
                               bk=K)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = G.lut_dequant_gemm(tx, _t(qw["codes"]), _t(qw["scales"]),
                             _t(qw["codebook"]), scheme=scheme)
    assert got.dtype == tx.dtype and got.shape == (M, N)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_wrappers_reject_bad_operands():
    with pytest.raises(ValueError):
        PA.paged_attention(torch.zeros(1, 1, 1, 8), torch.zeros(2, 4, 1, 8),
                           torch.zeros(2, 4, 1, 8), torch.zeros(1, 1),
                           torch.ones(1), exp_mode="softmax")
    with pytest.raises(ValueError):
        PA.paged_attention(torch.zeros(1, 1, 1, 8), torch.zeros(2, 4, 1, 8),
                           torch.zeros(2, 4, 1, 8), torch.zeros(1, 1),
                           torch.ones(1), exp_mode="lut")  # no LUT
    with pytest.raises(ValueError):
        G.lut_dequant_gemm(torch.zeros(2, 8), torch.zeros(8, 4),
                           torch.zeros(4, 1), torch.zeros(16),
                           scheme="rows")
