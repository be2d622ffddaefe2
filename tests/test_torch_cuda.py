"""The port's CUDA kernels against their plain versions, on the card.

These tests import neither JAX nor the JAX package, so they run on a GPU
machine without JAX (``--noconftest`` skips the suite's JAX fixtures):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py

Without a GPU they skip.
"""
import pytest
import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.kernels import lut_dequant_gemm as G
from repro_torch.kernels import lut_dequant_kv as K4
from repro_torch.kernels import lut_softmax_attention as K5
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import tile_quantize as K6
from repro_torch.quant import tile_quant as TQ
from repro_torch.serving.kv_quant import kv_tile_geometry, quantize_kv
from repro_torch.serving.sampler import SamplerConfig

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
@pytest.mark.parametrize("shape", [dict(), dict(Hkv=1, G_=6, D=32, bs=32),
                                   dict(Hkv=32, G_=1, D=80, bs=16),
                                   dict(Hkv=1, G_=6, D=8)])
def test_cuda_paged_attention_matches_plain(cuda, kind, exp_mode, shape):
    """Ragged rows with a window; the third shape is stablelm-3b's (Hkv
    32, head_dim 80: 40-byte Q4 and 80-byte Q8 code rows, loaded in 4-byte
    chunks), the fourth head_dim 8 (8- and 4-byte code rows)."""
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
    """Code rows that are not a multiple of 16 bytes load in 4-byte
    chunks, at most 4 KiB of a KV head's block (here 128 rows of head_dim
    40: 40-byte q8 rows, 20-byte q4 rows only at 256 rows, past G x bs);
    16-byte chunks take at most 8 KiB (here 64 rows of f32 head_dim 64)."""
    args = [_to(a, cuda) for a in _case(kind, Hkv=1, G_=1, D=40, bs=128)]
    if kind == "q8":
        with pytest.raises(ValueError, match="4-byte"):
            PA.quant_paged_attention(*args, None, ops.q4_codebook(cuda),
                                     exp_mode="exact")
    else:
        got = PA.quant_paged_attention(*args, None, ops.q4_codebook(cuda),
                                       exp_mode="exact")
        want = PA._plain(*args, None, 0, 0.0, "exact")
        torch.testing.assert_close(got, want, atol=ATOL["exact"], rtol=0)
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


# (mode, R, Hkv, D, gc): a partial warp (q8 R5 x 1 x 16 and q4 R3 x 1 x
# 32 are 20 and 24 float4s of output), partial blocks, scale groups of 1
# and 2 dims (one scale per element, not per float4), stablelm-3b's slab
# (Hkv 32, D 80: 40-byte q4 rows) and head_dim 8 (4-byte q4 rows)
K4_EDGES = [("q8", 5, 1, 16, 16), ("q4", 3, 1, 32, 16),
            ("q8", 37, 2, 128, 16), ("q4", 37, 2, 128, 16),
            ("q8", 300, 2, 64, 2), ("q4", 300, 2, 64, 2),
            ("q8", 9, 4, 96, 1), ("q4", 9, 4, 96, 1),
            ("q8", 1000, 2, 128, 4), ("q4", 1000, 2, 128, 4),
            ("q8", 37, 32, 80, 16), ("q4", 37, 32, 80, 16),
            ("q8", 9, 1, 8, 8), ("q4", 9, 1, 8, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("edge", K4_EDGES)
def test_cuda_lut_dequant_kv_edges_match_plain_bitwise(cuda, edge):
    mode, R, Hkv, D, gc = edge
    gr = 2 if Hkv % 2 == 0 else 1
    gen = torch.Generator().manual_seed(R * D + gc)
    q = _to(quantize_kv(torch.randn((R, Hkv, D), generator=gen) * 3.0,
                        mode=mode, gr=gr, gc=gc), cuda)
    args = (q["codes"], q["scales"], ops.q4_codebook(cuda))
    got = K4.lut_dequant_kv(*args, mode=mode, gr=gr, gc=gc)
    want = K4.plain_lut_dequant_kv(*args, mode=mode, gr=gr, gc=gc)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["q8", "q4"])
def test_cuda_lut_dequant_kv_is_deterministic(cuda, mode):
    gr, gc = kv_tile_geometry(2, 128)
    gen = torch.Generator().manual_seed(11)
    q = _to(quantize_kv(torch.randn((12544, 2, 128), generator=gen),
                        mode=mode, gr=gr, gc=gc), cuda)
    a, b = (ops.lut_dequant_gather(q) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_lut_dequant_kv_rejects_short_rows(cuda):
    """head_dim 4 gives 2-byte q4 code rows, which the kernel does not
    take (rows of a multiple of 4 bytes only; the plain version covers
    them on the CPU)."""
    q = _to(quantize_kv(torch.randn((4, 1, 4)), mode="q4", gr=1, gc=4), cuda)
    with pytest.raises(ValueError, match="multiple of 4 bytes"):
        ops.lut_dequant_gather(q)


# (BH, Sq, Skv, D, kv_group, causal, bkv): an odd KV block (79, prime S)
# with one KV head for four query heads, KV blocks of 64 and 128 over one
# input, a causal Sq < Skv, a KV block of 256 and head_dim 32; then the
# tensor-core kernel's edges: KV blocks that are not a multiple of its k
# step of 16 (100, and 79 with causal Sq < Skv), query rows that fill
# neither a warp's 16 nor a block's 64 (8, 79, 130), G 6, and KV blocks of
# 256 at head_dim 128
FLASH_SHAPES = [(4, 79, 79, 128, 4, True, 79), (6, 256, 256, 64, 3, True, 64),
                (6, 256, 256, 64, 3, True, 128), (4, 48, 192, 32, 2, True, 96),
                (8, 40, 512, 64, 1, False, 256),
                (12, 200, 200, 128, 6, True, 100),
                (3, 100, 300, 64, 3, False, 100),
                (6, 79, 237, 32, 3, True, 79),
                (2, 8, 1024, 64, 1, False, 128),
                (12, 130, 256, 128, 6, True, 256),
                (2, 16, 512, 128, 1, True, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("exp_mode", ["lut", "poly", "exact", "lut_shared",
                                      "lut_global"])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_cuda_lut_softmax_attention_matches_plain(cuda, exp_mode, shape,
                                                  monkeypatch):
    """lut: the table where the wrapper puts it; lut_shared / lut_global:
    forced into shared memory / read through the cache."""
    if "_" in exp_mode:
        monkeypatch.setattr(K5, "_LUT_IN_SHARED", exp_mode == "lut_shared")
    exp_mode = exp_mode.split("_")[0]
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
@pytest.mark.parametrize("exp_mode", ["lut_shared", "lut_global", "poly",
                                      "exact"])
def test_cuda_lut_softmax_attention_is_deterministic(cuda, exp_mode,
                                                     monkeypatch):
    """One pass per (head, 64-row tile), no split KV: two calls, the same
    bits; the LUT read from shared memory or through the cache alike."""
    monkeypatch.setattr(K5, "_LUT_IN_SHARED", exp_mode == "lut_shared")
    exp_mode = exp_mode.split("_")[0]
    gen = torch.Generator().manual_seed(2)
    q = (torch.randn((12, 300, 128), generator=gen) * 0.5).half().to(cuda)
    k, v = ((torch.randn((2, 300, 128), generator=gen) * 0.5).half().to(cuda)
            for _ in range(2))
    kw = dict(causal=True, bq=300, bkv=100, exp_mode=exp_mode, kv_group=6)
    a, b = (K5.lut_softmax_attention(q, k, v, ops.exp_lut(cuda), **kw)
            for _ in range(2))
    want = K5.lut_softmax_attention(q.cpu(), k.cpu(), v.cpu(), ops.exp_lut(),
                                    **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    torch.testing.assert_close(a.cpu().float(), want.float(), atol=2e-3,
                               rtol=0)


@pytest.mark.gpu
def test_cuda_lut_softmax_attention_lut_placement(cuda):
    """The table goes to shared memory only when the grid (BH x 64-row
    tiles) fits in one block per SM."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert K5.lut_in_shared(sms, 64, cuda)
    assert K5.lut_in_shared(1, 64 * sms, cuda)
    assert not K5.lut_in_shared(sms, 65, cuda)
    assert not K5.lut_in_shared(12, 2048, cuda)


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


def _quantize_case(K, N, dtype, seed):
    """Random weights with an all-zero group and, where K >= 4 and N >=
    16, a group on exact half steps of its scale (round half to even)."""
    w = torch.randn((K, N), generator=torch.Generator().manual_seed(seed))
    w = w * 0.2
    w[0:2, N - 16:N] = 0.0
    if K >= 4:
        ties = torch.tensor([0.5, 1.5, 2.5, 3.5, -0.5, -1.5, -2.5, -6.5,
                             6.5, 7.5, -7.5, 8.0, -8.0, 4.5, -4.5, 5.5])
        w[K - 2, 0:16], w[K - 1, 0:16] = ties, -ties
    return w.to(dtype)


# shapes that do not fill the kernel's tiling: one warp holding several
# row pairs (N 32), a row pair ending mid-warp (N 288), a single row pair
# (K 2), a grid with a ragged last block (K 1538); each with either load
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("kn", [(64, 32), (130, 288), (2, 256), (1538, 96),
                                (2, 32)])
@pytest.mark.parametrize("wide", [False, True])
def test_cuda_tile_quantize_edges_match_plain_bitwise(cuda, dtype, kn, wide):
    K, N = kn
    w = _quantize_case(K, N, dtype, seed=K + N)
    want = K6.tile_quantize(w)
    got = K6._launch(w.to(cuda), wide)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.gpu
def test_cuda_tile_quantize_launch_floor_counts_nowhere(cuda):
    """The empty kernel launches on the quantize kernel's grid and is not
    a launch of the kernel; the wide loads start at 16 MiB of weight."""
    assert not K6.wide_loads(torch.empty((1536, 1536), device=cuda))
    assert K6.wide_loads(torch.empty((1536, 8960), device=cuda))
    w = torch.zeros((1536, 256), device=cuda)
    before = K6.tile_quantize.launches
    K6.empty_launch(w)
    torch.cuda.synchronize()
    assert K6.tile_quantize.launches == before


@pytest.mark.gpu
def test_cuda_tile_quantize_rejects_what_it_cannot_take(cuda):
    with pytest.raises(ValueError, match="group_size 32"):
        K6.tile_quantize(torch.zeros((4, 64), device=cuda), group_size=64)
    with pytest.raises(ValueError, match="contiguous"):
        K6.tile_quantize(torch.zeros((64, 4), device=cuda).t())


# K3 at the edges of its two tensor-core tilings (M <= 32: small, then
# large) and of the n8 row tiles, with N = 96 leaving a partial 64-column
# warp tile; f32 x runs the CUDA-core kernel
GEMM_M = [1, 8, 16, 17, 32, 33, 79, 133, 300]
GEMM_TOL = {torch.float32: (1e-3, 1e-3),
            # the bf16 / f16 bars plus one rounding step of the output
            torch.bfloat16: (2e-2, 2e-2 + 2.0 ** -7),
            torch.float16: (2e-2, 2e-2 + 2.0 ** -10)}


def _gemm_args(M, K, N, dtype, scheme, cuda, codebook="q4_0"):
    gen = torch.Generator().manual_seed(M * 7 + N)
    qw = _to(TQ.quantize(torch.randn((K, N), generator=gen) * 0.1,
                         scheme=scheme, codebook=codebook), cuda)
    x = torch.randn((M, K), generator=gen).to(dtype).to(cuda)
    return x, qw["codes"], qw["scales"], qw["codebook"]


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["tile", "common"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("M", GEMM_M)
@pytest.mark.parametrize("kn", [(512, 96), (1536, 256)])
def test_cuda_lut_dequant_gemm_regimes_match_plain(cuda, scheme, dtype, M,
                                                   kn):
    K, N = kn
    args = _gemm_args(M, K, N, dtype, scheme, cuda)
    pl = G.plan(M, K, N, dtype, scheme)
    if dtype == torch.float32:
        assert pl.regime == "cuda_core"
    elif M > G.SMALL_M:
        assert pl.regime == "large_m"
    else:
        assert pl.regime == "small_m"
        assert pl.mt == (1 if M <= 8 else 2 if M <= 16 else 4)
    before = G.lut_dequant_gemm.launches
    got = G.lut_dequant_gemm(*args, scheme=scheme)
    assert G.lut_dequant_gemm.launches == before + 1
    want = G.plain_lut_dequant_gemm(*args)
    torch.cuda.synchronize()
    atol, rtol = GEMM_TOL[dtype]
    err = (got.float() - want.float()).abs()
    assert bool((err <= atol + rtol * want.float().abs()).all()), \
        float(err.max())


@pytest.mark.gpu
@pytest.mark.parametrize("codebook", ["nf4", "iq4_nl"])
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("M", [8, 33])
def test_cuda_lut_dequant_gemm_other_codebooks_match_plain(cuda, codebook,
                                                          dtype, M):
    """Codebooks that are not an integer grid c + cb0 take the kernel's
    shared-memory lookup instead of its packed integer dequantization."""
    args = _gemm_args(M, 512, 96, dtype, "tile", cuda, codebook)
    got = G.lut_dequant_gemm(*args)
    want = G.plain_lut_dequant_gemm(*args)
    torch.cuda.synchronize()
    atol, rtol = GEMM_TOL[dtype]
    err = (got.float() - want.float()).abs()
    assert bool((err <= atol + rtol * want.float().abs()).all()), \
        float(err.max())


@pytest.mark.gpu
@pytest.mark.parametrize("M", [8, 17, 133])
def test_cuda_lut_dequant_gemm_is_deterministic(cuda, M):
    """Split-K sums in warp order, no atomics: two calls, the same bits."""
    args = _gemm_args(M, 1536, 256, torch.bfloat16, "tile", cuda)
    a = G.lut_dequant_gemm(*args)
    b = G.lut_dequant_gemm(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def _split_case(kind, dtype, cuda, seed=3):
    """qwen2.5-1.5b's decode geometry (Hkv 2, G 6, D 128, 16-token blocks)
    on a 7-block table: a zero-length row, a full row, and ragged rows
    whose live blocks start mid-table under a window of 48."""
    B, Hkv, G_, D, bs, W = 4, 2, 6, 128, 16, 7
    nb = 1 + B * W
    gen = torch.Generator().manual_seed(seed)
    q = (torch.randn((B, Hkv, G_, D), generator=gen) * 0.5).to(dtype)
    pools = []
    for _ in range(2):
        fp = torch.randn((nb, bs, Hkv, D), generator=gen) * 0.5
        gr, gc = kv_tile_geometry(Hkv, D)
        pools.append(fp.to(dtype) if kind == "fp"
                     else quantize_kv(fp, mode=kind, gr=gr, gc=gc))
    lens = torch.tensor([0, W * bs, 50, 97], dtype=torch.int32)
    table = torch.zeros((B, W), dtype=torch.int32)
    perm = torch.randperm(nb - 1, generator=gen) + 1
    used = 0
    for b in range(B):
        n = -(-int(lens[b]) // bs)
        table[b, :n] = perm[used:used + n]
        used += n
    return [_to(a, cuda) for a in (q, pools[0], pools[1], table, lens)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["fp", "q8", "q4"])
@pytest.mark.parametrize("exp_mode", ["exact", "lut"])
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("n_splits", [1, 2, 4, 7, None])
def test_cuda_paged_attention_splits_match_plain(cuda, kind, exp_mode,
                                                 window, n_splits):
    """Split-KV at 1, 2, 4 and 7 (one block each) splits and the wrapper's
    own count, over W = 7 blocks (not divisible by 2 or 4): the same
    function as the sequential plain version, at its bars."""
    q, kp, vp, table, lens = _split_case(kind, torch.float32, cuda)
    lut = ops.exp_lut(cuda) if exp_mode == "lut" else None
    wrapper = PA.paged_attention if kind == "fp" else PA.quant_paged_attention
    cb = None if kind == "fp" else ops.q4_codebook(cuda)
    if n_splits is None:
        before = wrapper.launches
        got = wrapper(q, kp, vp, table, lens, lut,
                      *(() if cb is None else (cb,)), window=window,
                      exp_mode=exp_mode)
        assert wrapper.launches == before + 1
    else:  # the wrappers take their count from the shapes alone
        got = PA._launch(q, kp, vp, table, lens, lut, cb, window=window,
                         softcap=0.0, exp_mode=exp_mode, n_splits=n_splits)
    want = PA._plain(q, kp, vp, table, lens, lut, window, 0.0, exp_mode)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=ATOL[exp_mode], rtol=0)
    assert float(got[0].abs().max()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["fp", "q8", "q4"])
@pytest.mark.parametrize("exp_mode", ["exact", "lut"])
def test_cuda_paged_attention_is_deterministic(cuda, kind, exp_mode):
    """The fold runs in split order, with no atomics: two calls, the same
    bits (bf16, the served type)."""
    args = _split_case(kind, torch.bfloat16, cuda)
    lut = ops.exp_lut(cuda) if exp_mode == "lut" else None
    wrapper = PA.paged_attention if kind == "fp" else PA.quant_paged_attention
    extra = () if kind == "fp" else (ops.q4_codebook(cuda),)
    assert PA.splits(*args[0].shape[:2], args[3].shape[1]) == 7
    a = wrapper(*args, lut, *extra, exp_mode=exp_mode)
    b = wrapper(*args, lut, *extra, exp_mode=exp_mode)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["q8", "q4"])
def test_cuda_quant_paged_attention_small_scale_groups(cuda, kind):
    """A pool of QuantKVPool(group_size=8) (scale groups of 4 head dims):
    q8 (at most 4 groups per 16-byte chunk) matches the plain version, and
    so does q4, whose 16-byte chunk would span 8 groups and which loads in
    4-byte chunks (2 groups each); q4 groups of 1 head dim are refused
    rather than read wrongly."""
    gen = torch.Generator().manual_seed(5)
    B, Hkv, G_, D, bs, W = 2, 2, 3, 32, 4, 3
    q = torch.randn((B, Hkv, G_, D), generator=gen) * 0.5
    gr, gc = kv_tile_geometry(Hkv, D, group_size=8)
    assert gc == 4
    kp, vp = (quantize_kv(torch.randn((1 + B * W, bs, Hkv, D),
                                      generator=gen) * 0.5,
                          mode=kind, gr=gr, gc=gc) for _ in range(2))
    table = torch.arange(1, 1 + B * W, dtype=torch.int32).reshape(B, W)
    lens = torch.tensor([W * bs, 5], dtype=torch.int32)
    args = [_to(a, cuda) for a in (q, kp, vp, table, lens)]
    cb = ops.q4_codebook(cuda)
    if kind == "q4":
        gr1, gc1 = kv_tile_geometry(Hkv, D, group_size=2)
        one = [_to(quantize_kv(torch.randn((1 + B * W, bs, Hkv, D),
                                           generator=gen),
                               mode=kind, gr=gr1, gc=gc1), cuda)
               for _ in range(2)]
        with pytest.raises(ValueError, match="scale groups"):
            PA.quant_paged_attention(args[0], *one, *args[3:], None, cb)
    got = PA.quant_paged_attention(*args, None, cb)
    want = PA._plain(*args, None, 0, 0.0, "exact")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=ATOL["exact"], rtol=0)


# ---------------------------------------------------------------------------
# the speculative verify: its new K3 M and K4 R, and the whole call
# ---------------------------------------------------------------------------

# qwen2.5-1.5b's Q4 projections (K, N) and a verify at 8 slots x W 2..4
QWEN_KN = [(1536, 1536), (1536, 256), (1536, 8960)]


@pytest.mark.gpu
@pytest.mark.parametrize("M", [16, 24, 32])
@pytest.mark.parametrize("kn", QWEN_KN)
def test_cuda_lut_dequant_gemm_verify_m_matches_plain(cuda, M, kn):
    """K3 at the verify's M = 8 slots x W (bf16, the served type)."""
    args = _gemm_args(M, *kn, torch.bfloat16, "tile", cuda)
    assert G.plan(M, *kn, torch.bfloat16).regime == "small_m"
    got = G.lut_dequant_gemm(*args)
    want = G.plain_lut_dequant_gemm(*args)
    torch.cuda.synchronize()
    atol, rtol = GEMM_TOL[torch.bfloat16]
    err = (got.float() - want.float()).abs()
    assert bool((err <= atol + rtol * want.float().abs()).all()), \
        float(err.max())


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["q8", "q4"])
@pytest.mark.parametrize("prefix_w", [1, 4])
def test_cuda_lut_dequant_kv_verify_r_matches_plain_bitwise(cuda, mode,
                                                            prefix_w):
    """K4 at a verify's prefix gather: R = 28 layers x 8 slots x prefix_w
    blocks x 16 tokens, gathered through ``ops.lut_dequant_gather`` in the
    (L, B, P, Hkv, D) layout the engine hands it."""
    gen = torch.Generator().manual_seed(prefix_w)
    gr, gc = kv_tile_geometry(2, 128)
    P = prefix_w * 16
    q = _to(quantize_kv(torch.randn((28 * 8 * P, 2, 128), generator=gen),
                        mode=mode, gr=gr, gc=gc), cuda)
    view = {k: v.reshape(28, 8, P, *v.shape[1:]) for k, v in q.items()}
    before = K4.lut_dequant_kv.launches
    got = ops.lut_dequant_gather(view)
    assert K4.lut_dequant_kv.launches == before + 1
    assert K4.lut_dequant_kv.shapes[mode, 28 * 8 * P] >= 1
    want = K4.plain_lut_dequant_kv(q["codes"], q["scales"],
                                   ops.q4_codebook(cuda), mode=mode, gr=gr,
                                   gc=gc)
    torch.cuda.synchronize()
    assert torch.equal(got.reshape(want.shape), want)


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["q8", "q4"])
def test_cuda_spec_verify_matches_cpu(cuda, kv):
    """``DecodeEngine.spec_verify`` on the card (K4 prefix gather, K3 at
    M = 3 rows x W 4) against the same call on the CPU (plain versions),
    from the same W4A16 weights and prompts: the same commit mask and
    lengths, the next pending logits within the reference check's bars
    (q8 5e-3, q4 5e-2), and the pool drained after trim and release."""
    import numpy as np

    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import transformer as TR
    from repro_torch.quant.qlinear import quantize_model_params
    from repro_torch.serving.engine import DecodeEngine

    cfg = ModelConfig(name="verify", n_layers=2, d_model=128, n_heads=4,
                      n_kv_heads=2, d_ff=256, vocab_size=320,
                      dtype="float32", qkv_bias=True, tie_embeddings=True)
    params = quantize_model_params(TR.init_params(cfg, seed=3, device="cpu"))
    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(3, 300, (3, 13), generator=gen,
                            dtype=torch.int32)
    lens = torch.tensor([13, 5, 9], dtype=torch.int32)

    def tree(x, dev):
        if isinstance(x, dict):
            return {k: tree(v, dev) for k, v in x.items()}
        if isinstance(x, list):
            return [tree(v, dev) for v in x]
        return x.to(dev)

    def engine(dev):
        return DecodeEngine(tree(params, dev), cfg, max_len=64, paged=True,
                            block_size=8, n_blocks=1 + 3 * 8, kv_quant=kv)

    # proposals: the CPU's greedy continuation, cut by a wrong token at
    # column 3 (row 0), 1 (row 1) and past n_prop (row 2)
    ref = engine("cpu")
    st = ref.prefill(prompts, lens)
    st, greedy = ref.generate(st, 4, None, SamplerConfig(greedy=True))
    ref.release_rows(st, [0, 1, 2])
    xs = greedy.numpy().copy()
    xs[0, 3] = (xs[0, 3] + 1) % 320
    xs[1, 1] = (xs[1, 1] + 1) % 320
    n_prop = np.array([4, 4, 2], np.int32)
    out = []
    for dev in ("cpu", cuda):
        eng = engine(dev)
        st = eng.prefill(prompts, lens)
        k3, k4 = G.lut_dequant_gemm.launches, K4.lut_dequant_kv.launches
        st, commit = eng.spec_verify(st, xs, n_prop, stop_ids=(9999,))
        if dev == cuda:
            torch.cuda.synchronize()
            assert K4.lut_dequant_kv.launches - k4 == 2
            assert G.lut_dequant_gemm.launches - k3 == 2 * 6
        st = eng.trim_rows(st, [0, 1, 2])
        out.append((commit, st.cache_len.cpu(), st.pending_logits.cpu(),
                    st.n_blocks.copy()))
        eng.release_rows(st, [0, 1, 2])
        assert eng.pool.blocks_in_use == 0
    (c0, l0, p0, n0), (c1, l1, p1, n1) = out
    assert (c0.sum(1) == [3, 1, 2]).all() and (c1 == c0).all()
    assert torch.equal(l0, l1) and (n0 == n1).all()
    torch.testing.assert_close(p1, p0, atol={"q8": 5e-3, "q4": 5e-2}[kv],
                               rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["q8", "q4"])
def test_cuda_profiler_hook_and_canary(cuda, kv, monkeypatch):
    """The profiler on the card: every op the dispatch hook records is one
    kernel launch (the canary's own launches, made with the hook muted,
    apart); a canary on every other step leaves the tokens and every pool
    byte as a run without a profiler; its drift stays within the
    reference check's bars (q8 5e-3, q4 5e-2); and the engine selects the
    "plain" impl only inside ``_canary_step``, which launches no paged
    attention kernel."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as TR
    from repro_torch.quant.qlinear import quantize_model_params
    from repro_torch.serving.engine import (ContinuousScheduler,
                                            DecodeEngine, Request)
    from repro_torch.serving.profiling import (KernelProfiler,
                                               validate_profile_report)

    cfg = ModelConfig(name="canary", n_layers=2, d_model=128, n_heads=4,
                      n_kv_heads=2, d_ff=256, vocab_size=320,
                      dtype="float32", qkv_bias=True, tie_embeddings=True)
    params = quantize_model_params(TR.init_params(cfg, seed=3, device=cuda))
    gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(3, 300, (n,), generator=gen, dtype=torch.int32)
               for n in (13, 5, 9)]
    seen, canary_launches = [], []
    orig_pda, orig_canary = L.paged_decode_attention, \
        DecodeEngine._canary_step
    inside = [False]

    def pda(*a, **kw):
        seen.append((L._PAGED_ATTN_IMPL, inside[0]))
        return orig_pda(*a, **kw)

    def canary(self, *a, **kw):
        before = ops.launch_counts()
        inside[0] = True
        try:
            return orig_canary(self, *a, **kw)
        finally:
            inside[0] = False
            after = ops.launch_counts()
            canary_launches.append({k: after[k] - before[k] for k in after})

    monkeypatch.setattr(L, "paged_decode_attention", pda)
    monkeypatch.setattr(DecodeEngine, "_canary_step", canary)

    def serve(profiler):
        eng = DecodeEngine(params, cfg, max_len=64, paged=True, block_size=8,
                           n_blocks=1 + 6 * 8, kv_quant=kv)
        sched = ContinuousScheduler(eng, n_slots=4, prompt_len=16,
                                    stop_ids=(9999,), profiler=profiler)
        for i, p in enumerate(prompts):
            sched.submit(Request(req_id=i, prompt=p, max_new_tokens=12,
                                 n_samples=2 if i == 0 else 1))
        ops.reset_launch_counts()
        try:
            res = sched.run(torch.Generator(device=cuda).manual_seed(0),
                            SamplerConfig(temperature=0.8))
        finally:
            if profiler is not None:
                profiler.uninstall()
        torch.cuda.synchronize()
        pool = [t.clone() for leaf in (eng.pool.k, eng.pool.v)
                for t in leaf.values()]
        return res, ops.launch_counts(), pool, sched

    want, _, pool0, _ = serve(None)
    prof = KernelProfiler(sample_rate=1.0, canary_rate=0.5)
    got, counts, pool1, sched = serve(prof)
    assert got == want
    assert all(torch.equal(a, b) for a, b in zip(pool0, pool1))
    rep = prof.report()
    assert validate_profile_report(rep) == []
    s = sched.metrics.summary()
    assert s["canary_samples"] == len(canary_launches) > 0
    in_canary = {k: sum(c[k] for c in canary_launches) for k in counts}
    assert in_canary["quant_paged_attention"] == 0
    assert in_canary["lut_dequant_gemm"] > 0
    k = rep["kernels"]
    assert k["lut_dequant_matmul"]["calls"] == \
        counts["lut_dequant_gemm"] - in_canary["lut_dequant_gemm"]
    assert k["paged_flash_decode"]["calls"] == \
        counts["quant_paged_attention"] == \
        cfg.n_layers * rep["phases"]["decode"]["calls"]
    assert s["canary_max_logit_err"] <= {"q8": 5e-3, "q4": 5e-2}[kv]
    assert {impl for impl, c in seen if c} == {L.PLAIN_IMPL}
    assert L.PLAIN_IMPL not in {impl for impl, c in seen if not c}
    assert ops.op_hook() is None


def _device_activity(prof):
    """(name, start s, end s) of each device activity ``torch.profiler``
    recorded, on its own clock."""
    def ns(ev, what):
        f = getattr(ev, f"{what}_ns", None)
        return float(f()) if f is not None \
            else float(getattr(ev, f"{what}_us")()) * 1e3

    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            s = ns(ev, "start") * 1e-9
            out.append((ev.name(), s, s + ns(ev, "duration") * 1e-9))
    return out


@pytest.mark.gpu
def test_cuda_tracer_spans_on_the_device_clock(cuda):
    """A span's Unix stamps hold the kernel it waited for on the clock
    ``torch.profiler`` stamps device activity with (within 50 us, its end
    under 0.5 ms after the kernel's), and a ``sample``-style span's
    ``device_s`` is the marked pass's time by CUDA events, within 10%
    (medians of 5; the span's time includes its launch gaps, so the pass
    is long: 8 GiB moved, ~2.6 ms)."""
    from repro_torch.serving.telemetry import Tracer, cuda_mark

    x = torch.ones(1 << 30, device=cuda)
    torch.cuda._sleep(1000)
    x.mul_(1.0)
    torch.cuda.synchronize()
    bare = []
    for _ in range(5):
        a = cuda_mark(cuda)
        x.mul_(1.0)
        b = cuda_mark(cuda)
        b.synchronize()
        bare.append(a.elapsed_time(b) / 1e3)
    tr = Tracer()
    marked = []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = tr.anchor()
        torch.cuda._sleep(4_000_000)             # ~2 ms at ~2 GHz
        torch.cuda.synchronize()
        probe = tr.span("probe", t0)
        for _ in range(5):
            t0, e0 = tr.now(), cuda_mark(cuda)
            x.mul_(1.0)
            marked.append(tr.span("sample", t0))
            tr.time_on_device(marked[-1], e0, cuda_mark(cuda))
            torch.cuda.synchronize()
            tr.resolve_device()
    acts = _device_activity(prof)
    spins = [a for a in acts if "spin" in a[0] or "sleep" in a[0]]
    assert len(spins) == 1, [a[0] for a in acts]
    _, k0, k1 = spins[0]
    device_s = [sp.args["device_s"] for sp in marked]
    passes = [1e3 * (e - s) for n, s, e in acts if "spin" not in n]
    print(f"spin kernel {1e3 * (k1 - k0):.4f} ms; kernel start - u0 "
          f"{1e6 * (k0 - probe.u0):.1f} us, u1 - kernel end "
          f"{1e6 * (probe.u1 - k1):.1f} us; sample device_s ms "
          f"{[round(1e3 * d, 4) for d in device_s]}, bare events ms "
          f"{[round(1e3 * b, 4) for b in bare]}, profiled passes ms "
          f"{[round(p, 4) for p in passes]}")
    assert probe.u0 - 50e-6 <= k0 and k1 <= probe.u1 + 50e-6
    assert probe.u1 - k1 < 0.5e-3
    assert sorted(device_s)[2] == pytest.approx(sorted(bare)[2], rel=0.1)


# ---------------------------------------------------------------------------
# the decode forward replayed from one CUDA graph
# ---------------------------------------------------------------------------

GRAPH_CFGS = {
    # W4A16, bf16 activations: K3 at M = the slots, K2 on a Q8 pool, the
    # head's bf16 product to f32 logits
    "w4a16": dict(name="graph", n_layers=2, d_model=64, n_heads=4,
                  n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
                  dtype="bfloat16", qkv_bias=True, tie_embeddings=True),
    # olmoe-1b-7b's smoke shape (Hkv = Hq), W4A16: the routing, the
    # capacity dispatch and the experts' dequant inside the graph
    "moe": dict(name="graph-moe", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=4, head_dim=16, d_ff=0, vocab_size=512,
                dtype="bfloat16",
                moe=MoEConfig(n_experts=8, top_k=2, expert_d_ff=64)),
    "smoke": None,   # qwen2.5-1.5b's smoke config: f32, unquantized
}


@pytest.mark.gpu
@pytest.mark.parametrize("which", sorted(GRAPH_CFGS))
def test_cuda_decode_graph_matches_eager(cuda, which, monkeypatch):
    """20 scheduler steps of Best-of-3 groups (post-fork copy-on-write)
    and plain requests that finish and are replaced, on a Q8 pool, once
    with the forward replayed from the engine's graph and once eager: the
    same tokens, every step's pending logits equal to the bit, the same
    launch counts; one capture, and each step's pending logits, held by
    the state, left unchanged by the next step's replay."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer as TR
    from repro_torch.quant.qlinear import cast_params, quantize_model_params
    from repro_torch.serving import engine as E

    kw = GRAPH_CFGS[which]
    cfg = ModelConfig(**kw) if kw else get_config("qwen2.5-1.5b",
                                                  smoke=True)
    params = TR.init_params(cfg.with_(dtype="float32"), seed=3, device=cuda)
    if kw:
        params = cast_params(quantize_model_params(params), torch.bfloat16)
    gen = torch.Generator().manual_seed(4)
    prompts = [torch.randint(3, 500, (int(n),), generator=gen,
                             dtype=torch.int32)
               for n in torch.randint(5, 30, (12,), generator=gen)]

    def serve(graph):
        if not graph:
            monkeypatch.setattr(E.DecodeGraph, "available",
                                staticmethod(lambda device: False))
        eng = E.DecodeEngine(params, cfg, max_len=96, paged=True,
                             block_size=16, n_blocks=1 + 8 * 6,
                             kv_quant="q8")
        sched = E.ContinuousScheduler(eng, n_slots=8, prompt_len=32,
                                      stop_ids=(7,))
        for i, p in enumerate(prompts):
            sched.submit(E.Request(req_id=i, prompt=p,
                                   max_new_tokens=3 + 2 * (i % 5),
                                   n_samples=3 if i % 4 == 0 else 1))
        logits, held = [], []
        core = eng._step_core

        def step_core(state, *a, **k):
            # the state's pending logits (the last step's, admissions
            # merged in) as the replay inside this step finds them
            before = state.pending_logits.clone() \
                if eng._graph is not None else None
            st, tok = core(state, *a, **k)
            if before is not None:
                held.append(torch.equal(state.pending_logits, before))
            logits.append(st.pending_logits.clone())
            return st, tok

        eng._step_core = step_core
        ops.reset_launch_counts()
        run = torch.Generator(device=cuda).manual_seed(0)
        steps = 0
        while sched.step_once(run, SamplerConfig(temperature=0.8)):
            steps += 1
        torch.cuda.synchronize()
        monkeypatch.undo()
        return (sched.completed, logits, ops.launch_counts(),
                ops.gemm_launches_by_shape(), eng, held, steps)

    want = serve(False)
    got = serve(True)
    assert want[4]._graph is None
    eng, held, steps = got[4], got[5], got[6]
    assert steps >= 16
    assert eng._graph is not None and eng._graph.replays == steps - 1
    toks = [{r: sorted((c.sample_idx, c.tokens) for c in cs)
             for r, cs in run[0].items()} for run in (want, got)]
    assert toks[0] == toks[1]
    assert len(want[1]) == len(got[1]) == steps
    diff = max(float((a - b).abs().max()) for a, b in zip(want[1], got[1]))
    print(f"{which}: {steps} steps, graph replays {eng._graph.replays}, "
          f"max |graph - eager| logit {diff}, launches {got[2]}")
    assert all(torch.equal(a, b) for a, b in zip(want[1], got[1]))
    assert got[2] == want[2] and got[3] == want[3]
    assert got[2]["quant_paged_attention"] == cfg.n_layers * steps
    assert len(held) == steps - 2 and all(held)
