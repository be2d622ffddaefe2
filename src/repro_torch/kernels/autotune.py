"""Block sizes and analytic costs of the kernel wrappers.

Part of the JAX package's ``kernels/autotune``: :func:`pick_block` (the
divisibility contract every wrapper's block choice goes through) and the
plain flop and byte counts of the attention and quantize kernels, which
``chip_smoke.py`` turns into roofline bounds.  The rest waits for H100
constants: the per-shape cache of measured block winners and the
roofline-scored choice among valid candidates were tuned against the
TPU's peak rates and on-chip memory budget, which do not describe the
card.
"""
from __future__ import annotations


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


def attn_cost(BH: int, Sq: int, Skv: int, D: int, *,
              bq: int | None = None) -> tuple[float, float]:
    """LUT-softmax flash attention over (BH, Sq|Skv, D) fp16 operands:
    (flops, bytes), with k and v read once per q block when ``bq`` is
    given."""
    q_rep = 1 if bq is None else Sq // bq
    hbm = BH * (Sq * D * 2 + 2 * Skv * D * 2 * q_rep + Sq * D * 2)
    return 4.0 * BH * Sq * Skv * D, float(hbm)


def quantize_cost(K: int, N: int) -> tuple[float, float]:
    """Tile quantization of a (K, N) f32 weight to 4-bit codes:
    (flops, bytes)."""
    return 4.0 * K * N, float(K * N * 4 + K * N // 2)
