"""4-bit codebooks for LUT-centric dequantization (paper §5.2.2).

Once dequantization is a 16-entry table lookup, any 4-bit encoding
(Q4_0 integer grid, FP4, NF4, IQ4_NL) is supported by swapping table
contents.  Codes are unsigned 4-bit [0, 15]; ``dequant = codebook[code] *
scale`` with ``scale = max|w_group| / max|codebook|``.
"""
from __future__ import annotations

import numpy as np
import torch

# Q4_0: symmetric integer grid [-8, 7] (llama.cpp Q4_0 semantics).
Q4_0 = np.arange(-8.0, 8.0, dtype=np.float32)

# NF4 ("NormalFloat"), QLoRA (Dettmers et al. 2023), normalized to [-1, 1].
NF4 = np.array(
    [-1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
     -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
     0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
     0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
     0.7229568362236023, 1.0], dtype=np.float32)

# FP4 (E2M1): ±{0, .5, 1, 1.5, 2, 3, 4, 6}
FP4_E2M1 = np.array(
    [0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0,
     -0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0], dtype=np.float32)

# IQ4_NL non-linear grid (llama.cpp), scaled to int8-ish range.
IQ4_NL = np.array(
    [-127.0, -104.0, -83.0, -65.0, -49.0, -35.0, -22.0, -10.0,
     1.0, 13.0, 25.0, 38.0, 53.0, 69.0, 89.0, 113.0], dtype=np.float32)

CODEBOOKS = {
    "q4_0": Q4_0,
    "nf4": NF4,
    "fp4": FP4_E2M1,
    "iq4_nl": IQ4_NL,
}


def get_codebook(name: str, device=None) -> torch.Tensor:
    """The (16,) float32 table ``name`` on ``device`` (CPU by default)."""
    return torch.tensor(CODEBOOKS[name], dtype=torch.float32, device=device)


def codebook_absmax(name: str) -> float:
    return float(np.abs(CODEBOOKS[name]).max())
