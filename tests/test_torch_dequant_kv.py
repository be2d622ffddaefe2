"""K4 in the port against the JAX package: ``ops.lut_dequant_gather`` over
the same quantized (L, B, P, Hkv, D) prefix views must agree bit for bit
with the JAX package's ``ops.lut_dequant_gather`` (its Pallas kernel in
interpret mode), and with ``kv_quant.dequantize_kv``.  On the CPU the
port's wrapper runs its plain version; the CUDA kernel is held against
that plain version in ``test_torch_cuda.py`` and ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.serving import kv_quant as JKQ
from repro_torch.kernels import lut_dequant_kv as K4
from repro_torch.kernels import ops
from repro_torch.serving.kv_quant import dequantize_kv


def _view(mode, Hkv, D, seed, lead=(2, 3, 8)):
    """A quantized (L, B, P, Hkv, Dc) prefix view as numpy, quantized by
    the JAX package."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((*lead, Hkv, D)) * 2.0).astype(np.float32)
    gr, gc = JKQ.kv_tile_geometry(Hkv, D)
    q = JKQ.quantize_kv(jnp.asarray(x), mode=mode, gr=gr, gc=gc)
    return {k: np.array(v) for k, v in q.items()}


@pytest.mark.parametrize("mode", ["q8", "q4"])
@pytest.mark.parametrize("Hkv", [1, 2])
@pytest.mark.parametrize("D", [8, 16, 128])
def test_lut_dequant_gather_bitwise_matches_reference(mode, Hkv, D):
    view = _view(mode, Hkv, D, seed=D + Hkv)
    want = np.asarray(jops.lut_dequant_gather(
        {k: jnp.asarray(v) for k, v in view.items()}))
    before = K4.lut_dequant_kv.launches
    got = ops.lut_dequant_gather({k: torch.from_numpy(v)
                                  for k, v in view.items()})
    assert K4.lut_dequant_kv.launches == before  # CPU: the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    # bitwise: the same unpack, codebook lookup and one f32 multiply
    assert got.numpy().tobytes() == want.tobytes()
    same = dequantize_kv({k: torch.from_numpy(v) for k, v in view.items()})
    assert torch.equal(got, same)


def test_lut_dequant_gather_is_identity_on_fp_views():
    x = torch.randn((2, 3, 8, 2, 16))
    assert ops.lut_dequant_gather(x) is x


@pytest.mark.parametrize("R", [1, 37])
def test_plain_dequant_takes_any_row_count(R):
    """Unlike the Pallas kernel's row block, the port takes any R."""
    view = _view("q4", 2, 32, seed=R, lead=(R,))
    codes, scales = torch.from_numpy(view["codes"]), torch.from_numpy(
        view["scales"])
    out = K4.lut_dequant_kv(codes, scales, ops.q4_codebook(), mode="q4",
                            gr=2, gc=16)
    assert tuple(out.shape) == (R, 2, 32)
    assert torch.equal(out, dequantize_kv({"codes": codes,
                                           "scales": scales}))
    with pytest.raises(ValueError, match="q8 or q4"):
        K4.lut_dequant_kv(codes, scales, ops.q4_codebook(), mode="q2",
                          gr=2, gc=16)
