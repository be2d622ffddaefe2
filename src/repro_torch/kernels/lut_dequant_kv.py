"""KV token-slab dequantization (K4).

Wrapper around the CUDA kernel in ``csrc/lut_dequant_kv.cu``, which
replaces the JAX package's Pallas kernel ``lut_dequant_kv``: R gathered
token slabs of a tile-quantized KV pool, codes (R, Hkv, Dc) and f16
scales (R, Hkv//gr, D//gc), become (R, Hkv, D) f32, bit-identical to
``kv_quant.dequantize_kv``.  For CPU tensors the wrapper runs the plain
version (:func:`plain_lut_dequant_kv`); for CUDA tensors it launches the
kernel or raises; for ``meta`` tensors (the dry-run) it checks the
operands as for CUDA and returns an empty output of the kernel's shape.  ``lut_dequant_kv.launches`` counts kernel launches,
and ``lut_dequant_kv.shapes`` counts them by (mode, R).
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import build, ref

plain_lut_dequant_kv = ref.lut_dequant_kv_ref

_CODE_DTYPES = {"q8": torch.int8, "q4": torch.uint8}


def _lib() -> ctypes.CDLL:
    lib = build.load("lut_dequant_kv")
    fn = lib.lut_dequant_kv_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [I, P, P, P, P, I, I, I, I, I, I, I, P]
        fn.restype = ctypes.c_int
    return lib


def lut_dequant_kv(codes, scales, codebook, *, mode: str, gr: int, gc: int):
    """codes (R, Hkv, Dc) int8 (q8) or packed uint8 (q4, Dc = D/2), scales
    (R, Hkv//gr, D//gc) f16, codebook (16,) f32 -> (R, Hkv, D) f32.  On
    CUDA the kernel takes code rows of a multiple of 4 bytes (Dc % 4 ==
    0), 4-byte aligned: it reads 4 (q8) or 2 (q4) code bytes per float4 of
    output."""
    if mode not in _CODE_DTYPES:
        raise ValueError(f"mode must be q8 or q4, got {mode!r}")
    if codes.device.type == "cpu":
        return plain_lut_dequant_kv(codes, scales, codebook, mode=mode,
                                    gr=gr, gc=gc)
    if codes.dim() != 3:
        raise ValueError(f"codes must be (R, Hkv, Dc), got "
                         f"{tuple(codes.shape)}")
    R, H, Dc = codes.shape
    D = 2 * Dc if mode == "q4" else Dc
    if gr < 1 or gc < 1 or H % gr or D % gc:
        raise ValueError(f"tile ({gr}, {gc}) does not divide the (Hkv, D) "
                         f"= ({H}, {D}) slab")
    for t, name, dtype, shape in (
            (codes, "codes", _CODE_DTYPES[mode], (R, H, Dc)),
            (scales, "scales", torch.float16, (R, H // gr, D // gc)),
            (codebook, "codebook", torch.float32, (16,))):
        if t.device != codes.device or t.dtype != dtype or \
                tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: expected contiguous {dtype} {shape} on "
                f"{codes.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}{'' if t.is_contiguous() else ' (non-contiguous)'}")
    if Dc % 4:
        raise ValueError(f"the kernel takes code rows of a multiple of 4 "
                         f"bytes: rows of {Dc} bytes (head_dim {D}, {mode}) "
                         f"are not taken")
    out = torch.empty((R, H, D), dtype=torch.float32, device=codes.device)
    if codes.device.type == "meta":
        return out
    if codes.data_ptr() % 4:
        raise ValueError("the kernel takes codes 4-byte aligned")
    if R == 0:
        return out
    with torch.cuda.device(codes.device):
        err = _lib().lut_dequant_kv_launch(
            int(mode == "q4"), codes.data_ptr(), scales.data_ptr(),
            codebook.data_ptr(), out.data_ptr(), R, H, Dc, H // gr, D // gc,
            gr, gc, torch.cuda.current_stream(codes.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lut_dequant_kv kernel launch failed with CUDA "
                           f"error {err}")
    lut_dequant_kv.launches += 1
    lut_dequant_kv.shapes[mode, R] += 1
    return out


lut_dequant_kv.launches = 0
lut_dequant_kv.shapes = collections.Counter()
