"""W4A16 GEMM with in-kernel LUT dequantization (K3).

Wrapper around the CUDA kernel in ``csrc/lut_dequant_gemm.cu``, which
replaces the JAX package's Pallas kernel ``lut_dequant_gemm``:
x (M, K) @ (codebook[code] × broadcast scale) with packed int4 codes
(K, N/2), the weight rounded to x.dtype before an f32-accumulated product.
For CPU tensors the wrapper runs the plain version
(:func:`plain_lut_dequant_gemm`); for CUDA tensors it launches the kernel
or raises.  ``lut_dequant_gemm.launches`` counts kernel launches, and
``lut_dequant_gemm.shapes`` counts them by (M, K, N).
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import build, ref

plain_lut_dequant_gemm = ref.dequant_matmul_ref

SCHEMES = ("tile", "common")
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _lib() -> ctypes.CDLL:
    lib = build.load("lut_dequant_gemm")
    fn = lib.lut_dequant_gemm_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [I, I, P, P, P, P, P, I, I, I, I, P]
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
    if M == 0:
        return out
    with torch.cuda.device(x.device):
        err = _lib().lut_dequant_gemm_launch(
            _DTYPES[x.dtype], int(scheme == "tile"), x.data_ptr(),
            codes.data_ptr(), scales.data_ptr(), codebook.data_ptr(),
            out.data_ptr(), M, K, N, g,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lut_dequant_gemm kernel launch failed with CUDA "
                           f"error {err}")
    lut_dequant_gemm.launches += 1
    lut_dequant_gemm.shapes[M, K, N] += 1
    return out


lut_dequant_gemm.launches = 0
lut_dequant_gemm.shapes = collections.Counter()
