"""Block sizes, analytic costs and the roofline bound of the kernel
wrappers.

Part of the JAX package's ``kernels/autotune``: :func:`pick_block` (the
divisibility contract every wrapper's block choice goes through), one
cost model per kernel, each returning ``(flops, hbm_bytes)`` for one
call, and :func:`roofline_bound_s`.  ``serving/profiling.KernelProfiler``
divides measured wall time into these bounds and ``chip_smoke.py``
prints them beside each kernel's time, so the two can never disagree
about what a kernel should cost.

FLOPs are the JAX package's.  Bytes are what the port's kernels move:
bf16 activations in and out, packed 4-bit codes, f16 scales, the 16-entry
codebook, and the pool's storage bytes per token slab; the JAX package
counts its TPU kernels' f32 operands instead.

The rest of the JAX module stays there: the per-shape cache of measured
block winners and the roofline-scored choice among valid Pallas grids
rank block shapes under a VMEM budget and a per-grid-step cost that no
CUDA wrapper of the port consults.
"""
from __future__ import annotations

# NVIDIA H100 80GB HBM3, 700.00 W (SXM), published dense peaks: HBM
# bytes/s and FLOP/s by operand type (the served kernels run bf16)
HBM_BW = 3.35e12
PEAK_FLOPS_BY_DTYPE = {"bfloat16": 989e12, "float16": 989e12,
                       "float32": 67e12}
PEAK_FLOPS = PEAK_FLOPS_BY_DTYPE["bfloat16"]


def pick_block(n: int, target: int, multiple_of: int = 1) -> int:
    """Largest divisor of ``n`` that is <= ``target`` and a multiple of
    ``multiple_of``; falls back to ``n`` itself when no smaller divisor
    qualifies.

    Raises ``ValueError`` when no valid block exists at all, i.e. ``n``
    itself violates ``multiple_of``.
    """
    b = min(n, target)
    while b > 1 and (n % b or b % multiple_of):
        b -= 1
    if b > 1:
        return b
    if n % multiple_of:
        raise ValueError(
            f"no valid block size for an axis of size {n}: blocks must "
            f"divide {n} and be a multiple of {multiple_of} (target "
            f"{target}), but {n} itself is not a multiple of {multiple_of}")
    return n


def roofline_bound_s(flops: float, hbm_bytes: float) -> float:
    """Analytic lower bound on wall seconds: compute- or bandwidth-bound,
    whichever is worse.  The profiler divides it by measured wall time
    to get achieved-vs-peak efficiency."""
    return max(flops / PEAK_FLOPS, hbm_bytes / HBM_BW)


def gemm_cost(M: int, K: int, N: int, *, x_bytes: int = 2,
              scale_bytes: int | None = None) -> tuple[float, float]:
    """LUT-dequant GEMM (K3): x (M, K) @ 4-bit codes (K, N / 2 bytes) ->
    (M, N) in x's dtype (``x_bytes`` each), reading the f16 scales
    (default: the tile scheme's (K / 2, N / 16)) and the 64-byte
    codebook once."""
    if scale_bytes is None:
        scale_bytes = (K // 2) * (N // 16) * 2
    hbm = M * K * x_bytes + K * N // 2 + scale_bytes + 64 + M * N * x_bytes
    return 2.0 * M * N * K, float(hbm)


def attn_cost(BH: int, Sq: int, Skv: int, D: int, *,
              bq: int | None = None) -> tuple[float, float]:
    """LUT-softmax flash attention over (BH, Sq|Skv, D) fp16 operands:
    (flops, bytes), with k and v read once per q block when ``bq`` is
    given."""
    q_rep = 1 if bq is None else Sq // bq
    hbm = BH * (Sq * D * 2 + 2 * Skv * D * 2 * q_rep + Sq * D * 2)
    return 4.0 * BH * Sq * Skv * D, float(hbm)


def paged_attn_cost(B: int, Hq: int, W: int, bs: int, D: int, *,
                    slab_bytes: float, q_bytes: int = 2,
                    tokens: int | None = None) -> tuple[float, float]:
    """Paged decode attention (K1/K2): q (B, 1, Hq, D) against each row's
    table of W blocks of ``bs`` tokens.  ``slab_bytes`` is one token's
    (Hkv, D) slab in pool storage (codes + scales on a quantized pool), so
    a Q8 pool moves about half a bf16 pool's KV bytes.  ``tokens`` is the
    KV tokens attended over all rows; None counts every table slot
    (B W bs, the JAX package's count, which needs no read of the lengths).
    q is read and the output written in q's dtype (``q_bytes``), the
    table and lengths as int32."""
    if tokens is None:
        tokens = B * W * bs
    hbm = (2 * B * Hq * D * q_bytes + 2 * tokens * slab_bytes
           + B * W * 4 + B * 4)
    return 4.0 * Hq * D * tokens, float(hbm)


def dequant_kv_cost(R: int, H: int, D: int, mode: str, *, gr: int = 2,
                    gc: int = 16) -> tuple[float, float]:
    """KV-slab dequant (K4): R token slabs of (H, D) Q8 codes (or packed
    Q4) and (H / gr, D / gc) f16 scales -> f32, plus the codebook."""
    codes = R * H * (D // 2 if mode == "q4" else D)
    scales = R * (H // gr) * (D // gc) * 2
    return 2.0 * R * H * D, float(codes + scales + 64 + R * H * D * 4)


def quantize_cost(K: int, N: int, *,
                  scale_bytes: int = 0) -> tuple[float, float]:
    """Tile quantization (K6) of a (K, N) f32 weight to 4-bit codes:
    (flops, bytes).  ``scale_bytes``: the scales written beside the codes
    (K N / 16 for K6's f16 tile scales; 0 is the JAX package's count)."""
    return 4.0 * K * N, float(K * N * 4 + K * N // 2 + scale_bytes)
