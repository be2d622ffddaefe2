"""W4A16 GEMM with in-kernel LUT dequantization (K3).

Wrapper around the CUDA kernel in ``csrc/lut_dequant_gemm.cu``, which
replaces the JAX package's Pallas kernel ``lut_dequant_gemm``:
x (M, K) @ (codebook[code] × broadcast scale) with packed int4 codes
(K, N/2), the weight rounded to x.dtype before an f32-accumulated product.
For CPU tensors the wrapper runs the plain version
(:func:`plain_lut_dequant_gemm`); for CUDA tensors it launches the kernel
or raises; for ``meta`` tensors (the dry-run) it checks the operands as
for CUDA and returns an empty output of the kernel's shape and dtype.
:func:`plan` picks the kernel from the dtype, the geometry and
M alone: the tensor-core kernel in its small-M (M <= ``SMALL_M``) or
large-M tiling for bf16/f16 x, the CUDA-core kernel for f32 x.
``lut_dequant_gemm.launches`` counts kernel launches, and
``lut_dequant_gemm.shapes`` counts them by (M, K, N).
"""
from __future__ import annotations

import collections
import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref

plain_lut_dequant_gemm = ref.dequant_matmul_ref

SCHEMES = ("tile", "common")
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
SMALL_M = 32  # the largest M of the small-M (weight-byte-bound) tiling
_SMS = 132    # H100 SMs


class Plan(NamedTuple):
    """A launch of the kernel: ``regime`` "cuda_core", "small_m" (mt n8
    tiles of rows per block of 64 columns, K split over wk warps of a
    block and a cluster of kz blocks) or "large_m" (64 x 128 output tiles,
    K split over a cluster of kz blocks)."""
    regime: str
    mt: int = 0
    wk: int = 0
    kz: int = 0


def plan(M: int, K: int, N: int, dtype, scheme: str = "tile",
         group_size: int = 32, aligned: bool = True) -> Plan:
    """The kernel launch for these operands, from the dtype, the geometry
    and M alone.  16-bit x takes the tensor cores: up to ``SMALL_M`` rows
    the small-M tiling (mt 1, 2 or 4), above it the large-M tiling.  Both
    split K so that the grid fills the SMs: at small M a grid of fewer
    blocks than SMs splits K wider (the fastest of a sweep over the served
    shapes on the H100, ``scripts/sweep_gemm.py``).  The CUDA-core kernel
    takes f32 x and geometries the tensor-core kernels do not (K % 16,
    N % 32, scale groups that do not cover a lane's 2 x 8 weights, tile-
    scale rows of an odd number of groups, operands not 16-byte aligned;
    above ``SMALL_M`` also K % 32 and tile groups gc other than 8, 16, 32,
    64)."""
    gc = group_size // 2
    tc = (dtype in (torch.float16, torch.bfloat16) and aligned
          and K % 16 == 0 and N % 32 == 0
          and (gc % 8 == 0 and (N // gc) % 2 == 0 if scheme == "tile"
               else group_size % 16 == 0))
    if M > SMALL_M:
        tc = tc and K % 32 == 0 and (scheme != "tile"
                                     or gc in (8, 16, 32, 64))
    if not tc:
        return Plan("cuda_core")
    if M > SMALL_M:
        blocks = -(-N // 128) * -(-M // 64)
        kz = 1
        while kz < 8 and blocks * kz < _SMS and K // 32 >= 8 * kz:
            kz *= 2
        return Plan("large_m", 0, 0, kz)
    tiles = -(-M // 8)
    mt = 1 if M <= 8 else 2 if M <= 16 else 4
    blocks = -(-N // 64) * -(-tiles // mt)
    wk, kz = (8, 4) if blocks < _SMS else (8 if mt == 1 else 4, 1)
    steps = K // 16
    while kz > 1 and steps < 2 * wk * kz:  # >= 2 K steps per warp
        kz //= 2
    while wk > 1 and steps < 2 * wk:
        wk //= 2
    return Plan("small_m", mt, wk, kz)


_REGIMES = {"cuda_core": 0, "small_m": 1, "large_m": 2}


def _lib() -> ctypes.CDLL:
    lib = build.load("lut_dequant_gemm")
    fn = lib.lut_dequant_gemm_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [I, I, I, I, I, I, P, P, P, P, P, I, I, I, I, P]
        fn.restype = ctypes.c_int
    return lib


def lut_dequant_gemm(x, codes, scales, codebook, *, scheme: str = "tile",
                     group_size: int = 32):
    """x: (M, K) @ dequant(codes (K, N/2) uint8, scales f16 — (K/2, N/16)
    tile or (K/g, N) common — codebook (16,) f32) -> (M, N) in x.dtype."""
    if scheme not in SCHEMES:
        raise ValueError(f"scheme must be one of {SCHEMES}, got {scheme!r}")
    if x.device.type == "cpu":
        return plain_lut_dequant_gemm(x, codes, scales, codebook,
                                      group_size=group_size)
    if x.dtype not in _DTYPES or x.dim() != 2:
        raise ValueError(f"x must be a 2-D tensor of {list(_DTYPES)}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    M, K = x.shape
    if codes.dim() != 2 or codes.shape[0] != K:
        raise ValueError(f"codes {tuple(codes.shape)} do not match x "
                         f"{tuple(x.shape)} (need (K, N/2))")
    N = codes.shape[1] * 2
    g = group_size
    want = (K // 2, N // (g // 2)) if scheme == "tile" else (K // g, N)
    if (scheme == "tile" and (K % 2 or N % (g // 2))) or \
            (scheme == "common" and K % g):
        raise ValueError(f"({K}, {N}) does not tile into {scheme} groups of "
                         f"{g}")
    for t, name, dtype, shape in ((x, "x", x.dtype, (M, K)),
                                  (codes, "codes", torch.uint8, (K, N // 2)),
                                  (scales, "scales", torch.float16, want),
                                  (codebook, "codebook", torch.float32,
                                   (16,))):
        if t.device != x.device or t.dtype != dtype or \
                tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(
                f"{name}: expected contiguous {dtype} {tuple(shape)} on "
                f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
                f"{'' if t.is_contiguous() else ' (non-contiguous)'}")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or x.device.type == "meta":
        return out
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, codes, scales))
    pl = plan(M, K, N, x.dtype, scheme, g, aligned)
    with torch.cuda.device(x.device):
        err = _lib().lut_dequant_gemm_launch(
            _DTYPES[x.dtype], int(scheme == "tile"), _REGIMES[pl.regime],
            pl.mt, pl.wk, pl.kz,
            x.data_ptr(), codes.data_ptr(), scales.data_ptr(),
            codebook.data_ptr(), out.data_ptr(), M, K, N, g,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lut_dequant_gemm kernel launch failed with CUDA "
                           f"error {err}")
    lut_dequant_gemm.launches += 1
    lut_dequant_gemm.shapes[M, K, N] += 1
    return out


lut_dequant_gemm.launches = 0
lut_dequant_gemm.shapes = collections.Counter()
