"""Hardware-aware tile-group weight quantization (paper §5.1).

Two group geometries over a (K, N) weight (K = reduction dim):

* ``common`` — groups of ``g`` contiguous elements along K, one scale per
  (g, 1) column strip (the llama.cpp / AutoAWQ baseline layout);
* ``tile`` — (2, g//2) rectangles: 2 K-rows × 16 N-columns, the paper's
  register-tile shape, so codes and scales read unit-stride.

Codes are packed two per byte along N (low nibble = even column).  Codes
and scales are bit-identical to the JAX package's quantizer: the same f32
arithmetic, round-to-nearest-even f16 scales and first-index argmin.
"""
from __future__ import annotations

import torch

from repro_torch.quant.codebooks import codebook_absmax, get_codebook

SCHEMES = ("common", "tile")

# rows of the (rows, N, 16) nearest-code distance tensor built at once;
# keeps the argmin's scratch to ~rows*N*64 bytes at full model width
_ARGMIN_ROWS = 256


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """(K, N) uint8 in [0,15] -> (K, N//2) packed: low nibble = even col."""
    return codes[:, 0::2] | (codes[:, 1::2] << 4)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(K, N//2) uint8 -> (K, N) uint8 in [0,15]."""
    K, Nh = packed.shape
    return torch.stack([packed & 0xF, packed >> 4], dim=-1).reshape(K, Nh * 2)


def _nearest_code(wn: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest-codebook-entry index of each normalized weight (first index
    on ties), computed a block of rows at a time."""
    out = torch.empty(wn.shape, dtype=torch.uint8, device=wn.device)
    for r in range(0, wn.shape[0], _ARGMIN_ROWS):
        d = (wn[r:r + _ARGMIN_ROWS, :, None] - codebook).abs()
        out[r:r + _ARGMIN_ROWS] = torch.argmin(d, dim=-1).to(torch.uint8)
    return out


def _expand_tile(s: torch.Tensor, K: int, N: int, gr: int, gc: int):
    """(K//gr, N//gc) -> (K, N) by repeating each scale over its tile."""
    return s[:, None, :, None].expand(K // gr, gr, N // gc, gc).reshape(K, N)


def quantize(w: torch.Tensor, *, scheme: str = "tile", codebook: str = "q4_0",
             group_size: int = 32, scale_dtype=torch.float16) -> dict:
    """Weight-only 4-bit group quantization.

    Returns {"codes": (K, N//2) uint8, "scales": ..., "codebook": (16,)
    f32}; ``scales`` is (K//g, N) for ``common`` and (K//2, N//(g//2)) for
    ``tile``.
    """
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}; expected {SCHEMES}")
    K, N = w.shape
    g = group_size
    cb = get_codebook(codebook, device=w.device)
    cmax = codebook_absmax(codebook)
    wf = w.to(torch.float32)
    if scheme == "common":
        if K % g:
            raise ValueError(f"common scheme needs K % {g} == 0, got K={K}")
        absmax = wf.reshape(K // g, g, N).abs().amax(dim=1)
        scales = (absmax / cmax).to(scale_dtype)
        sc = scales.float().repeat_interleave(g, dim=0)
    else:
        gr, gc = 2, g // 2
        if K % gr or N % gc:
            raise ValueError(f"tile scheme needs K % {gr} == 0 and "
                             f"N % {gc} == 0, got {(K, N)}")
        absmax = wf.reshape(K // gr, gr, N // gc, gc).abs().amax(dim=(1, 3))
        scales = (absmax / cmax).to(scale_dtype)
        sc = _expand_tile(scales.float(), K, N, gr, gc)
    sc = torch.clamp_min(sc, 1e-8)
    codes = _nearest_code(wf / sc, cb)
    return {"codes": pack_int4(codes), "scales": scales, "codebook": cb}


def infer_scheme(qw: dict, group_size: int = 32) -> str:
    """Recover the group geometry from array shapes."""
    K = qw["codes"].shape[0]
    return "common" if qw["scales"].shape[0] == K // group_size else "tile"


def dequantize(qw: dict, *, dtype=torch.float32,
               group_size: int = 32) -> torch.Tensor:
    """Reference dequantization: codebook lookup times broadcast scale, in
    f32, then cast to ``dtype``."""
    idx = unpack_int4(qw["codes"]).long()
    K, N = idx.shape
    vals = qw["codebook"][idx]
    s = qw["scales"].float()
    g = group_size
    if infer_scheme(qw, group_size) == "common":
        w = (vals.reshape(K // g, g, N) * s[:, None, :]).reshape(K, N)
    else:
        gr, gc = 2, g // 2
        w = (vals.reshape(K // gr, gr, N // gc, gc)
             * s[:, None, :, None]).reshape(K, N)
    return w.to(dtype)


def quantize_q8(w: torch.Tensor, *, group_size: int = 32,
                scale_dtype=torch.float16) -> dict:
    """Q8_0-style 8-bit symmetric group quantization (FFN down, §7.1)."""
    K, N = w.shape
    g = group_size
    if K % g:
        raise ValueError(f"Q8 needs K % {g} == 0, got K={K}")
    wf = w.to(torch.float32)
    absmax = wf.reshape(K // g, g, N).abs().amax(dim=1)
    scales = (absmax / 127.0).to(scale_dtype)
    sc = torch.clamp_min(scales.float().repeat_interleave(g, dim=0), 1e-8)
    codes = torch.clamp(torch.round(wf / sc), -127, 127).to(torch.int8)
    return {"codes": codes, "scales": scales}


def dequantize_q8(qw: dict, *, dtype=torch.float32,
                  group_size: int = 32) -> torch.Tensor:
    codes = qw["codes"]
    K, N = codes.shape
    g = group_size
    w = codes.float().reshape(K // g, g, N) * qw["scales"].float()[:, None, :]
    return w.reshape(K, N).to(dtype)
