"""The port's CUDA kernels against their plain versions, on the card.

These tests import neither JAX nor the JAX package, so they run on a GPU
machine without JAX (``--noconftest`` skips the suite's JAX fixtures):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py

Without a GPU they skip.
"""
import pytest
import torch

from repro_torch.kernels import lut_dequant_gemm as G
from repro_torch.kernels import lut_dequant_kv as K4
from repro_torch.kernels import lut_softmax_attention as K5
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import tile_quantize as K6
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


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["q8", "q4"])
@pytest.mark.parametrize("R", [1, 37, 1792, 12544])
def test_cuda_lut_dequant_kv_matches_plain_bitwise(cuda, mode, R):
    """The partial-prefill shapes of qwen2.5-1.5b (R = 28 layers x 64
    cached tokens x 1 or 7 rows; Hkv 2, D 128) and ragged R: the same
    single f32 multiply per element, so bit for bit."""
    gen = torch.Generator().manual_seed(R)
    gr, gc = kv_tile_geometry(2, 128)
    q = _to(quantize_kv(torch.randn((R, 2, 128), generator=gen) * 3.0,
                        mode=mode, gr=gr, gc=gc), cuda)
    before = K4.lut_dequant_kv.launches
    got = ops.lut_dequant_gather(q)
    assert K4.lut_dequant_kv.launches == before + 1
    want = K4.plain_lut_dequant_kv(q["codes"], q["scales"],
                                   ops.q4_codebook(cuda), mode=mode, gr=gr,
                                   gc=gc)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_cuda_lut_dequant_kv_rejects_short_rows(cuda):
    """head_dim 8 gives 4-byte q4 code rows, which the kernel's 16-byte
    loads do not take (the plain version covers them on the CPU)."""
    q = _to(quantize_kv(torch.randn((4, 1, 8)), mode="q4", gr=1, gc=8), cuda)
    with pytest.raises(ValueError, match="16-byte"):
        ops.lut_dequant_gather(q)


# (BH, Sq, Skv, D, kv_group, causal, bkv): an odd KV block (79, prime S)
# with one KV head for four query heads, KV blocks of 64 and 128 over one
# input, a causal Sq < Skv, a KV block of 256 and head_dim 32
FLASH_SHAPES = [(4, 79, 79, 128, 4, True, 79), (6, 256, 256, 64, 3, True, 64),
                (6, 256, 256, 64, 3, True, 128), (4, 48, 192, 32, 2, True, 96),
                (8, 40, 512, 64, 1, False, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("exp_mode", ["lut", "poly", "exact"])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_cuda_lut_softmax_attention_matches_plain(cuda, exp_mode, shape):
    BH, Sq, Skv, D, G_, causal, bkv = shape
    gen = torch.Generator().manual_seed(BH * Skv + bkv)
    q = (torch.randn((BH, Sq, D), generator=gen) * 0.5).half()
    k, v = ((torch.randn((BH // G_, Skv, D), generator=gen) * 0.5).half()
            for _ in range(2))
    kw = dict(causal=causal, bq=Sq, bkv=bkv, exp_mode=exp_mode, kv_group=G_)
    want = K5.lut_softmax_attention(q, k, v, ops.exp_lut(), **kw)
    before = K5.lut_softmax_attention.launches
    got = K5.lut_softmax_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                                   ops.exp_lut(cuda), **kw)
    assert K5.lut_softmax_attention.launches == before + 1
    torch.cuda.synchronize()
    # the JAX package's kernel-vs-oracle bar
    torch.testing.assert_close(got.cpu().float(), want.float(), atol=2e-3,
                               rtol=0)


@pytest.mark.gpu
def test_cuda_lut_softmax_attention_rejects_what_it_cannot_take(cuda):
    q = torch.zeros((2, 64, 48), dtype=torch.float16, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        K5.lut_softmax_attention(q, q, q, ops.exp_lut(cuda), exp_mode="lut")
    q = torch.zeros((2, 512, 64), dtype=torch.float16, device=cuda)
    with pytest.raises(ValueError, match="at most 256"):
        K5.lut_softmax_attention(q, q, q, None, bkv=512, exp_mode="exact")
    with pytest.raises(ValueError, match="exp LUT"):
        K5.lut_softmax_attention(q, q, q, None, exp_mode="lut")
    with pytest.raises(ValueError, match="fp16"):
        K5.lut_softmax_attention(q.float(), q, q, None, exp_mode="exact")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("kn", [(128, 256), (1536, 256), (96, 8960)])
def test_cuda_tile_quantize_matches_plain_bitwise(cuda, dtype, kn):
    """Random weights with an all-zero group and a group on exact half
    steps of its scale (round half to even): bit for bit."""
    K, N = kn
    w = torch.randn((K, N), generator=torch.Generator().manual_seed(K)) * 0.2
    w[0:2, 0:16] = 0.0
    ties = torch.tensor([0.5, 1.5, 2.5, 3.5, -0.5, -1.5, -2.5, -6.5, 6.5,
                         7.5, -7.5, 8.0, -8.0, 4.5, -4.5, 5.5])
    w[2, 0:16], w[3, 0:16] = ties, -ties
    w = w.to(dtype)
    want = K6.tile_quantize(w)
    before = K6.tile_quantize.launches
    got = K6.tile_quantize(w.to(cuda))
    assert K6.tile_quantize.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    leaf = ops.tile_quantize_op(w.to(cuda))
    assert TQ.infer_scheme(leaf) == "tile" and leaf["codebook"].is_cuda


@pytest.mark.gpu
def test_cuda_tile_quantize_rejects_what_it_cannot_take(cuda):
    with pytest.raises(ValueError, match="group_size 32"):
        K6.tile_quantize(torch.zeros((4, 64), device=cuda), group_size=64)
    with pytest.raises(ValueError, match="contiguous"):
        K6.tile_quantize(torch.zeros((64, 4), device=cuda).t())
