"""K6 in the port against the JAX package: ``ops.tile_quantize_op`` on the
same numpy weights gives codes and scales bit-identical to the JAX
package's (its Pallas kernel in interpret mode), and a leaf that the port's
K3 takes as the JAX leaf's K3 does.  On the CPU the port's wrapper runs its
plain version; the CUDA kernel is held against that plain version in
``test_torch_cuda.py`` and ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops
from repro_torch.kernels import tile_quantize as K6
from repro_torch.quant import tile_quant as TQ


def _weight(K, N, seed, scale=0.2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((K, N)) * scale).astype(np.float32)


def _assert_same_leaf(got: dict, want: dict):
    assert got["codes"].dtype == torch.uint8
    assert got["scales"].dtype == torch.float16
    np.testing.assert_array_equal(got["codes"].numpy(),
                                  np.asarray(want["codes"]))
    # scales bit for bit (fp16 patterns)
    np.testing.assert_array_equal(
        got["scales"].numpy().view(np.uint16),
        np.asarray(want["scales"]).view(np.uint16))
    np.testing.assert_array_equal(got["codebook"].numpy(),
                                  np.asarray(want["codebook"]))


@pytest.mark.parametrize("kn", [(128, 256), (256, 512), (512, 1024)])
def test_tile_quantize_op_bitwise_matches_jax(kn):
    w = _weight(*kn, seed=kn[0])
    before = K6.tile_quantize.launches
    got = ops.tile_quantize_op(torch.from_numpy(w))
    assert K6.tile_quantize.launches == before  # CPU: the plain version
    _assert_same_leaf(got, jops.tile_quantize_op(jnp.asarray(w)))


def test_tile_quantize_bf16_weight_matches_jax():
    w = _weight(128, 256, seed=3)
    wj = jnp.asarray(w).astype(jnp.bfloat16)
    got = ops.tile_quantize_op(torch.from_numpy(w).bfloat16())
    _assert_same_leaf(got, jops.tile_quantize_op(wj))


def test_tile_quantize_zero_group_and_half_step_ties():
    """An all-zero group (scale 0, every code 8) and weights exactly on
    half steps of their group's scale (round half to even)."""
    w = _weight(64, 128, seed=4)
    w[0:2, 0:16] = 0.0
    # group (rows 2-3, cols 0-15): absmax 8 -> scale 1, w / scale = w
    ties = np.array([0.5, 1.5, 2.5, 3.5, -0.5, -1.5, -2.5, -6.5, 6.5, 7.5,
                     -7.5, 8.0, -8.0, 4.5, -4.5, 5.5], np.float32)
    w[2, 0:16] = ties
    w[3, 0:16] = -ties
    # group (rows 4-5, cols 16-31): scale 0.25, values on odd quarter-halves
    w[4, 16:32] = ties * 0.25
    w[5, 16:32] = ties[::-1] * 0.25
    got = ops.tile_quantize_op(torch.from_numpy(w))
    _assert_same_leaf(got, jops.tile_quantize_op(jnp.asarray(w)))
    codes = TQ.unpack_int4(got["codes"]).numpy().astype(int)
    assert float(got["scales"][0, 0]) == 0.0 and (codes[0:2, 0:16] == 8).all()
    even = np.clip(np.round(ties), -8, 7).astype(int) + 8  # half to even
    assert even[:4].tolist() == [8, 10, 10, 12]
    np.testing.assert_array_equal(codes[2, 0:16], even)
    np.testing.assert_array_equal(codes[4, 16:32], even)
    assert float(got["scales"][1, 0]) == 1.0
    assert float(got["scales"][2, 1]) == 0.25


@pytest.mark.parametrize("kn", [(128, 256), (512, 1024)])
def test_tile_quantize_agrees_with_offline_quantizer(kn):
    """The kernel's codes against the offline quantizer's: >= 99.9% of the
    4-bit codes equal (the JAX package's bar).  They differ where w / scale
    lies within the fp16 rounding of the scale of a half step: the kernel
    divides by the f32 scale, the offline quantizer by the fp16 one."""
    w = torch.from_numpy(_weight(*kn, seed=7))
    got = ops.tile_quantize_op(w)
    off = TQ.quantize(w, scheme="tile", codebook="q4_0")
    same = TQ.unpack_int4(got["codes"]) == TQ.unpack_int4(off["codes"])
    assert same.float().mean() >= 0.999
    assert torch.equal(got["scales"], off["scales"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_leaf_through_k3_matches_jax(dtype):
    """A K6 leaf through the port's lut_dequant_matmul against the JAX
    lut_dequant_matmul on the JAX K6 leaf, within the K3 bars."""
    K, N, M = 256, 512, 8
    w = _weight(K, N, seed=8, scale=0.1)
    x = np.random.default_rng(9).standard_normal((M, K)).astype(np.float32)
    jleaf = jops.tile_quantize_op(jnp.asarray(w))
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16
                               else jnp.float32)
    want = np.asarray(jops.lut_dequant_matmul(jx, jleaf).astype(jnp.float32))
    leaf = ops.tile_quantize_op(torch.from_numpy(w))
    assert TQ.infer_scheme(leaf) == "tile"
    got = ops.lut_dequant_matmul(torch.from_numpy(x).to(dtype), leaf)
    assert got.dtype == dtype
    tol = 1e-3 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


def test_tile_quantize_rejects_untileable_shapes():
    with pytest.raises(ValueError, match="K % 2"):
        K6.tile_quantize(torch.zeros((3, 64)))
    with pytest.raises(ValueError, match="N % 32"):
        K6.tile_quantize(torch.zeros((4, 48)))
