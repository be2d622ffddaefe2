"""The port's CUDA kernels against their plain versions, on the card.

These tests import neither JAX nor the JAX package, so they run on a GPU
machine without JAX (``--noconftest`` skips the suite's JAX fixtures):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py

Without a GPU they skip.
"""
import pytest
import torch

from repro_torch.kernels import lut_dequant_gemm as G
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as PA
from repro_torch.quant import tile_quant as TQ
from repro_torch.serving.kv_quant import kv_tile_geometry, quantize_kv

ATOL = {"exact": 2e-5, "lut": 2e-3}   # the JAX package's kernel bars


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels have no CPU "
                    "mode; their plain versions are tested against the JAX "
                    "package in test_torch_kernels.py)")
    return torch.device("cuda")


def _case(kind, B=3, nb=14, bs=4, Hkv=2, G_=4, W=6, D=32, seed=0):
    """Ragged paged-decode case on the CPU: row 1 empty, row 0 full."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((B, Hkv, G_, D), generator=gen) * 0.5
    pools = []
    for _ in range(2):
        fp = torch.randn((nb, bs, Hkv, D), generator=gen) * 0.5
        gr, gc = kv_tile_geometry(Hkv, D)
        pools.append(fp if kind == "fp"
                     else quantize_kv(fp, mode=kind, gr=gr, gc=gc))
    lens = torch.tensor([W * bs, 0, 9], dtype=torch.int32)
    table = torch.zeros((B, W), dtype=torch.int32)
    table[0] = torch.arange(1, W + 1)
    table[2, :3] = torch.tensor([9, 8, 7])
    return q, pools[0], pools[1], table, lens


def _to(x, dev):
    if isinstance(x, dict):
        return {k: v.to(dev) for k, v in x.items()}
    return x.to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["fp", "q8", "q4"])
@pytest.mark.parametrize("exp_mode", ["exact", "lut"])
@pytest.mark.parametrize("shape", [dict(), dict(Hkv=1, G_=6, D=32, bs=32)])
def test_cuda_paged_attention_matches_plain(cuda, kind, exp_mode, shape):
    args = _case(kind, **shape)
    want = PA._plain(*args, ops.exp_lut() if exp_mode == "lut" else None,
                     5, 0.0, exp_mode)
    wrapper = PA.paged_attention if kind == "fp" else PA.quant_paged_attention
    extra = () if kind == "fp" else (ops.q4_codebook(cuda),)
    before = wrapper.launches
    got = wrapper(*[_to(a, cuda) for a in args],
                  ops.exp_lut(cuda) if exp_mode == "lut" else None, *extra,
                  window=5, exp_mode=exp_mode)
    assert wrapper.launches == before + 1
    torch.testing.assert_close(got.cpu(), want, atol=ATOL[exp_mode], rtol=0)
    assert float(got[1].abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["tile", "common"])
@pytest.mark.parametrize("M", [8, 300])
def test_cuda_lut_dequant_gemm_matches_plain(cuda, scheme, M):
    gen = torch.Generator().manual_seed(M)
    qw = _to(TQ.quantize(torch.randn((256, 96), generator=gen) * 0.1,
                         scheme=scheme), cuda)
    x = torch.randn((M, 256), generator=gen).to(cuda)
    args = (x, qw["codes"], qw["scales"], qw["codebook"])
    got = G.lut_dequant_gemm(*args, scheme=scheme)
    want = G.plain_lut_dequant_gemm(*args)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)


@pytest.mark.gpu
def test_cuda_wrappers_reject_cpu_mixed_operands(cuda):
    x = torch.zeros((8, 64), device=cuda)
    qw = TQ.quantize(torch.randn(64, 32))  # left on the CPU
    with pytest.raises(ValueError):
        G.lut_dequant_gemm(x, qw["codes"], qw["scales"], qw["codebook"])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["q8", "q4"])
def test_cuda_paged_attention_rejects_short_rows(cuda, kind):
    """head_dim 8 gives 8-byte (q8) or 4-byte (q4) code rows, which the
    kernel's 16-byte loads do not take; the plain version covers that
    geometry on the CPU (test_torch_kernels.py).  Nor does it take a block
    of more than 8 KiB (here 64 rows of f32 head_dim 64)."""
    args = [_to(a, cuda) for a in _case(kind, Hkv=1, G_=6, D=8)]
    with pytest.raises(ValueError, match="16-byte"):
        PA.quant_paged_attention(*args, None, ops.q4_codebook(cuda),
                                 exp_mode="exact")
    args = [_to(a, cuda) for a in _case("fp", bs=64, D=64)]
    with pytest.raises(ValueError, match="16-byte"):
        PA.paged_attention(*args, None, exp_mode="exact")
