"""The yardstick: the card's published peaks and the least work of each
kernel call.  What a model needs for its tokens (its FLOPs, the keys K2
reads) is its family's rule (``families/<reference>.py``).

The cost rules are frozen copies of the port's ``kernels/autotune``
``gemm_cost`` and ``paged_attn_cost`` as of this benchmark's first
version; a test holds them equal to the port's at the cells' shapes, so
a change to either side shows.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def least_s(flops: float, nbytes: float) -> float:
    """The least time a call can take on the card: the larger of its
    operations over the peak rate and its bytes over the bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def gemm_cost(M: int, K: int, N: int, *, x_bytes: int = 2,
              scale_bytes=None) -> tuple:
    """K3: x (M, K) @ 4-bit codes (K, N / 2 bytes) -> (M, N), reading the
    tile scales (K / 2, N / 16) f16 and the 64-byte codebook once; x read
    once and the output written once.  (flops, bytes)."""
    if scale_bytes is None:
        scale_bytes = (K // 2) * (N // 16) * 2
    hbm = M * K * x_bytes + K * N // 2 + scale_bytes + 64 + M * N * x_bytes
    return 2.0 * M * N * K, float(hbm)


def paged_attn_cost(B: int, Hq: int, W: int, bs: int, D: int, *,
                    slab_bytes: float, q_bytes: int = 2,
                    tokens=None) -> tuple:
    """K1/K2: q (B, 1, Hq, D) against ``tokens`` KV tokens of
    ``slab_bytes`` each for K and for V (all B W bs table slots when
    None); q read and the output written once, the table and lengths as
    int32.  (flops, bytes)."""
    if tokens is None:
        tokens = B * W * bs
    hbm = (2 * B * Hq * D * q_bytes + 2 * tokens * slab_bytes
           + B * W * 4 + B * 4)
    return 4.0 * Hq * D * tokens, float(hbm)


def q8_slab_bytes(n_kv_heads: int, head_dim: int, gr: int = 2,
                  gc: int = 16) -> float:
    """One token's (Hkv, D) slab in a Q8 pool: int8 codes and one f16
    scale per (gr, gc) tile."""
    return float(n_kv_heads * head_dim
                 + (n_kv_heads // gr) * (head_dim // gc) * 2)

