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
# K4: KV token-slab dequant
# ---------------------------------------------------------------------------


def lut_dequant_kv_ref(codes, scales, codebook, *, mode: str, gr: int,
                       gc: int):
    """Dequantize KV token slabs: codes (R, Hkv, Dc) int8 (q8) or packed
    uint8 (q4, low nibble = even dim), scales (R, Hkv//gr, D//gc) f16,
    codebook (16,) f32 (unused for q8) -> (R, Hkv, D) f32, where R
    may stand for any leading dims.

    Per element ``val(code) * f32(scale[r, h // gr, d // gc])`` with one
    f32 multiply, ``val`` the int8 code (q8) or ``codebook[nibble]`` (q4,
    the 16-entry LUT of §5.2.2).  ``kv_quant.dequantize_kv`` calls this
    after reading (mode, gr, gc) off the leaf's shapes."""
    from repro_torch.serving.kv_quant import _broadcast_scales, _unpack_q4

    if mode == "q8":
        vals = codes.float()
    elif mode == "q4":
        vals = codebook.float()[_unpack_q4(codes).long()]
    else:
        raise ValueError(f"mode must be q8 or q4, got {mode!r}")
    return vals * _broadcast_scales(scales.float(), gr, gc)


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


# ---------------------------------------------------------------------------
# K5: LUT-softmax FlashAttention (paper Alg. 1, exp modes lut/poly/exact)
# ---------------------------------------------------------------------------

FLASH_EXP_MODES = ("lut", "poly", "exact")


def poly_exp(x16: torch.Tensor) -> torch.Tensor:
    """The fp16 polynomial exp2 baseline of Fig. 14: exp(x) = 2^(x log2 e),
    split into integer k (f32 floor) and fraction f, 2^f by a degree-4
    Taylor polynomial in f * ln 2 (Horner, one f32 rounding per multiply
    and add), scaled by 2^k, cast to fp16."""
    y = x16.float() * 1.4426950408889634
    k = torch.floor(y)
    t = (y - k) * 0.6931471805599453
    p = 1.0 + t * (1.0 + t * (0.5 + t * (1.0 / 6.0 + t * (1.0 / 24.0))))
    return torch.ldexp(p, k.to(torch.int32)).to(torch.float16)


def _exp16(x16: torch.Tensor, lut, exp_mode: str) -> torch.Tensor:
    if exp_mode == "lut":
        return lut_exp(lut, x16)
    if exp_mode == "poly":
        return poly_exp(x16)
    return torch.exp(x16.float()).to(torch.float16)


def lut_flash_attention_ref(q, k, v, lut=None, *, causal: bool = True,
                            bkv: int = 128, exp_mode: str = "lut",
                            kv_group: int = 1):
    """The fp16 FlashAttention recurrence of Alg. 1 over KV blocks of
    ``bkv`` rows, with the Pallas kernel's rounding points: S = f32 q.k^T
    times the f32 scale, ``NEG_CAP`` where kpos > qpos (top-left aligned)
    when causal, S rounded to fp16, m kept in fp16, x = s16 - m_new an fp16
    subtraction, p and the correction factor from ``exp_mode`` (the exp
    LUT, :func:`poly_exp` or f32 exp, each rounded to fp16), l and acc in
    f32, out = acc / max(l, 1e-30) in fp16.  The fp16 m is rounded once
    per block, so ``bkv`` is part of the function.

    q: (BH, Sq, D) fp16; k, v: (BH // kv_group, Skv, D) fp16 (query head
    bh reads KV head bh // kv_group).  Returns (BH, Sq, D) fp16."""
    if exp_mode not in FLASH_EXP_MODES:
        raise ValueError(f"exp_mode must be one of {FLASH_EXP_MODES}, "
                         f"got {exp_mode!r}")
    if exp_mode == "lut":
        lut = (build_exp_lut() if lut is None else lut).to(q.device)
    if kv_group > 1:
        k = k.repeat_interleave(kv_group, dim=0)
        v = v.repeat_interleave(kv_group, dim=0)
    BH, Sq, D = q.shape
    Skv = k.shape[1]
    bkv = min(bkv, Skv)
    if Skv % bkv:
        raise ValueError(f"bkv={bkv} does not divide Skv={Skv}")
    scale = 1.0 / math.sqrt(D)
    qf = q.float()
    m = torch.full((BH, Sq, 1), NEG_CAP, dtype=torch.float16,
                   device=q.device)
    l = torch.zeros((BH, Sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((BH, Sq, D), dtype=torch.float32, device=q.device)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    for j in range(Skv // bkv):
        kj = k[:, j * bkv:(j + 1) * bkv].float()
        vj = v[:, j * bkv:(j + 1) * bkv].to(torch.float16).float()
        s = torch.bmm(qf, kj.transpose(1, 2)) * scale
        if causal:
            kpos = j * bkv + torch.arange(bkv, device=q.device)[None]
            s = torch.where(kpos <= qpos, s, NEG_CAP)
        s16 = s.to(torch.float16)
        m_new = torch.maximum(m, s16.amax(dim=-1, keepdim=True))
        p = _exp16(s16 - m_new, lut, exp_mode)
        corr = _exp16(m - m_new, lut, exp_mode).float()
        l = l * corr + p.float().sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.bmm(p.float(), vj)
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)).to(torch.float16)


def attention_f32_ref(q, k, v, *, causal: bool = True):
    """Conventional f32 softmax attention over (BH, S, D) (the yardstick of
    Fig. 14 and Table 5); causal masks kpos > qpos."""
    D = q.shape[-1]
    s = torch.bmm(q.float(), k.float().transpose(1, 2)) / math.sqrt(D)
    if causal:
        Sq, Skv = q.shape[1], k.shape[1]
        mask = (torch.arange(Skv, device=q.device)[None]
                <= torch.arange(Sq, device=q.device)[:, None])
        s = torch.where(mask, s, float("-inf"))
    return torch.bmm(torch.softmax(s, dim=-1), v.float())


# ---------------------------------------------------------------------------
# K6: on-device tile quantization
# ---------------------------------------------------------------------------


def tile_quantize_ref(w: torch.Tensor, *, group_size: int = 32):
    """The tile-quantize kernel's arithmetic (not the offline quantizer's
    nearest-code search): w widened to f32; per (2, group_size // 2)
    group, scale = absmax / 8 in f32, stored as fp16; codes =
    clip(round_half_even(w / max(scale, 1e-8)), -8, 7) + 8, dividing by
    the f32 scale, packed two per byte along N (low nibble = even column).

    w: (K, N) -> (codes (K, N // 2) uint8, scales (K // 2, N // gc) fp16)."""
    K, N = w.shape
    gr, gc = 2, group_size // 2
    if K % gr or N % gc or N % 2:
        raise ValueError(f"(2, {gc}) groups do not tile a {(K, N)} weight")
    g = w.float().reshape(K // gr, gr, N // gc, gc)
    scales = g.abs().amax(dim=(1, 3)) / 8.0
    sc = torch.clamp_min(scales, 1e-8)[:, None, :, None]
    q = (torch.round(g / sc).clamp(-8, 7) + 8).reshape(K, N).to(torch.uint8)
    return q[:, 0::2] | (q[:, 1::2] << 4), scales.to(torch.float16)
