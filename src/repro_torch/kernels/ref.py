"""Plain PyTorch versions of the port's CUDA kernels.

Each function computes what its kernel computes, with the kernel's
rounding points, in straightforward tensor ops.  The kernel wrappers run
them for CPU tensors, the CPU tests hold them against the JAX package's
Pallas kernels (interpret mode), and ``chip_smoke.py`` holds each CUDA
kernel against them on the card.  They are device-agnostic.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.quant import tile_quant as TQ

NEG_CAP = -30000.0  # finite "-inf" in fp16 range; LUT(e^{-30000}) == 0
LUT_SIZE = 32768


def build_exp_lut() -> torch.Tensor:
    """(1, 32768) fp16 table: LUT[i] = exp(x) for the fp16 x with bit
    pattern (0x8000 | i), computed in f32; -inf/NaN patterns hold 0.

    Safe softmax keeps every exp argument <= 0, so the sign bit is
    constant and the low 15 bits of the fp16 pattern index the table
    (paper §5.2.1)."""
    bits = (np.arange(LUT_SIZE, dtype=np.uint32) | 0x8000).astype(np.uint16)
    x = torch.from_numpy(bits.view(np.float16).astype(np.float32))
    vals = torch.where(torch.isfinite(x), torch.exp(x), torch.zeros_like(x))
    return vals.to(torch.float16).reshape(1, LUT_SIZE)


def lut_exp(lut: torch.Tensor, x16: torch.Tensor) -> torch.Tensor:
    """fp16 exp of x16 (<= 0) through the 15-bit table index."""
    idx = x16.view(torch.int16).to(torch.int32) & 0x7FFF
    return lut[0][idx.long()]


# ---------------------------------------------------------------------------
# K3: LUT-dequant GEMM
# ---------------------------------------------------------------------------


def dequant_matmul_ref(x, codes, scales, codebook, *, group_size: int = 32):
    """x (M, K) @ dequant(codes, scales, codebook) (K, N) -> (M, N) x.dtype.

    The dequantized weight is rounded to x.dtype before the product and
    the product accumulates in f32, as in the kernel (for f32 inputs this
    is the JAX package's ``dequant_matmul_ref``)."""
    qw = {"codes": codes, "scales": scales, "codebook": codebook}
    w = TQ.dequantize(qw, dtype=torch.float32, group_size=group_size)
    w = w.to(x.dtype).float()
    return (x.float() @ w).to(x.dtype)


# ---------------------------------------------------------------------------
# K1 / K2: paged decode attention (exact and LUT recurrences)
# ---------------------------------------------------------------------------


def gather_blocks(pool, blocks: torch.Tensor) -> torch.Tensor:
    """Pool blocks ``blocks`` (any shape) -> (*blocks.shape, bs, Hkv, D)
    f32, dequantizing {"codes", "scales"} pools."""
    if isinstance(pool, dict):
        from repro_torch.serving.kv_quant import dequantize_kv

        return dequantize_kv({"codes": pool["codes"][blocks],
                              "scales": pool["scales"][blocks]})
    return pool[blocks].float()


def _valid(lengths, kv_pos, window: int):
    """(B, S) validity of kv positions for the row's current query."""
    valid = kv_pos[None] < lengths[:, None]
    if window > 0:
        valid &= (lengths[:, None] - 1) - kv_pos[None] < window
    return valid


def paged_decode_attention_ref(q, k_pool, v_pool, table, lengths, *,
                               window: int = 0, softcap: float = 0.0):
    """Exact paged decode attention: gather the table's blocks and run
    masked f32 softmax attention.  A zero-length row returns 0.

    q: (B, Hkv, G, D); pools: (n_blocks, bs, Hkv, D) fp tensors or
    {"codes", "scales"} dicts; table: (B, W) int32 (block w of a row holds
    positions [w*bs, (w+1)*bs)); lengths: (B,) int32 including the current
    token.  Returns (B, Hkv, G, D) in q.dtype."""
    B, Hkv, G, D = q.shape
    W = table.shape[1]
    k = gather_blocks(k_pool, table.long())     # (B, W, bs, Hkv, D)
    v = gather_blocks(v_pool, table.long())
    bs = k.shape[2]
    k = k.reshape(B, W * bs, Hkv, D)
    v = v.reshape(B, W * bs, Hkv, D)
    s = torch.einsum("bhgd,bkhd->bhgk", q.float(), k) * (1.0 / math.sqrt(D))
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    kv_pos = torch.arange(W * bs, device=q.device)
    valid = _valid(lengths.long(), kv_pos, window)[:, None, None]
    s = torch.where(valid, s, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v) / torch.clamp_min(l, 1e-30)
    return o.to(q.dtype)


def lut_paged_decode_attention_ref(q, k_pool, v_pool, table, lengths, lut,
                                   *, window: int = 0, softcap: float = 0.0):
    """The fp16 Alg. 1 recurrence walked block by block through the table:
    masked scores rounded to fp16 (NEG_CAP), running max in fp16,
    ``s16 - m_new`` in fp16, exp by table lookup, l and acc in f32, v cast
    to fp16 for P·V.  Fully masked rows return 0.  Pools as in
    :func:`paged_decode_attention_ref`; returns (B, Hkv, G, D) q.dtype."""
    B, Hkv, G, D = q.shape
    W = table.shape[1]
    scale = 1.0 / math.sqrt(D)
    lut = lut.to(q.device)
    qf = q.float()
    m = torch.full((B, Hkv, G, 1), NEG_CAP, dtype=torch.float16,
                   device=q.device)
    l = torch.zeros((B, Hkv, G, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, G, D), dtype=torch.float32, device=q.device)
    lengths = lengths.long()
    for j in range(W):
        kj = gather_blocks(k_pool, table[:, j].long())  # (B, bs, Hkv, D)
        vj = gather_blocks(v_pool, table[:, j].long())
        bs = kj.shape[1]
        s = torch.einsum("bhgd,bshd->bhgs", qf, kj) * scale
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        kv_pos = j * bs + torch.arange(bs, device=q.device)
        vb = _valid(lengths, kv_pos, window)[:, None, None, :]
        s16 = torch.where(vb, s, NEG_CAP).to(torch.float16)
        m_new = torch.maximum(m, s16.amax(dim=-1, keepdim=True))
        p = lut_exp(lut, s16 - m_new)
        corr = lut_exp(lut, m - m_new).float()
        p = torch.where(vb, p, torch.zeros_like(p))
        l = l * corr + p.float().sum(dim=-1, keepdim=True)
        pv = torch.einsum("bhgs,bshd->bhgd", p.float(),
                          vj.to(torch.float16).float())
        acc = acc * corr + pv
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)
