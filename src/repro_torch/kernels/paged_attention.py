"""Paged single-query decode attention: K1 (fp pool) and K2 (Q8/Q4 pool).

Wrappers around the CUDA kernel in ``csrc/paged_attention.cu``, which
replaces the JAX package's Pallas kernels ``paged_attention`` and
``quant_paged_attention``.  One query token per row attends against a
block pool through the row's block table, with per-row lengths, a sliding
window (<= 0 = none), tanh softcap, and an exact f32 or fp16 LUT online
softmax.  For CPU tensors the wrappers run the plain versions
(:func:`plain_paged_attention`, :func:`plain_lut_paged_attention`); for
CUDA tensors they launch the kernel or raise.  ``launches`` on each
wrapper counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, ref

plain_paged_attention = ref.paged_decode_attention_ref
plain_lut_paged_attention = ref.lut_paged_decode_attention_ref

EXP_MODES = ("exact", "lut")
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_LOADERS = {"fp": 0, "q8": 1, "q4": 2}
_MAX_BLOCK_BYTES = 4 * 128 * 16  # kMaxChunks x kThreads 16-byte chunks


def _lib() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    fn = lib.paged_attention_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([I, I, I] + [P] * 10 + [I] * 11
                       + [ctypes.c_float, ctypes.c_float, P])
        fn.restype = ctypes.c_int
    return lib


def _check_mode(exp_mode: str, lut):
    if exp_mode not in EXP_MODES:
        raise ValueError(f"exp_mode must be one of {EXP_MODES}, "
                         f"got {exp_mode!r}")
    if exp_mode == "lut" and lut is None:
        raise ValueError("exp_mode='lut' needs the exp LUT "
                         "(repro_torch.kernels.ops.exp_lut())")


def _plain(q, k_pool, v_pool, table, lengths, lut, window, softcap,
           exp_mode):
    if exp_mode == "lut":
        return plain_lut_paged_attention(q, k_pool, v_pool, table, lengths,
                                         lut, window=window, softcap=softcap)
    return plain_paged_attention(q, k_pool, v_pool, table, lengths,
                                 window=window, softcap=softcap)


def _expect(t: torch.Tensor, name: str, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(q, k_pool, v_pool, table, lengths, lut, codebook, *, window,
            softcap, exp_mode):
    """Validate the operands and launch the kernel on the current stream."""
    dev = q.device
    if q.dtype not in _DTYPES or q.dim() != 4 or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous (B, Hkv, G, D) tensor of "
                         f"{list(_DTYPES)}, got {q.dtype} {tuple(q.shape)}")
    B, Hkv, G, D = q.shape
    quant = isinstance(k_pool, dict)
    if quant:
        from repro_torch.serving.kv_quant import kv_geometry

        mode, gr, gc, d = kv_geometry(k_pool)
        codes = k_pool["codes"]
        nb, bs = codes.shape[:2]
        if d != D:
            raise ValueError(f"pool head_dim {d} != q head_dim {D}")
        cdt = torch.int8 if mode == "q8" else torch.uint8
        dc = D if mode == "q8" else D // 2
        Hs, Ds = Hkv // gr, D // gc
        for name, pool in (("k_pool", k_pool), ("v_pool", v_pool)):
            _expect(pool["codes"], f"{name} codes", cdt, (nb, bs, Hkv, dc),
                    dev)
            _expect(pool["scales"], f"{name} scales", torch.float16,
                    (nb, bs, Hs, Ds), dev)
        k, v = k_pool["codes"], v_pool["codes"]
        ks, vs = k_pool["scales"].data_ptr(), v_pool["scales"].data_ptr()
        loader = _LOADERS[mode]
    else:
        nb, bs = k_pool.shape[:2]
        for name, pool in (("k_pool", k_pool), ("v_pool", v_pool)):
            _expect(pool, name, q.dtype, (nb, bs, Hkv, D), dev)
        k, v, ks, vs = k_pool, v_pool, None, None
        gr = gc = Hs = Ds = 1
        loader = _LOADERS["fp"]
    row = k.shape[-1] * k.element_size()
    if row % 16 or k.data_ptr() % 16 or v.data_ptr() % 16 or \
            bs * row > _MAX_BLOCK_BYTES:
        raise ValueError(
            f"the kernel loads a K/V block as at most {_MAX_BLOCK_BYTES} "
            f"bytes of 16-byte chunks: {bs} rows of {row} bytes (head_dim "
            f"{D}, {k.dtype}) or pools not 16-byte aligned are not taken")
    W = table.shape[1] if table.dim() == 2 else -1
    _expect(table, "table", torch.int32, (B, W), dev)
    _expect(lengths, "lengths", torch.int32, (B,), dev)
    lut_ptr = None
    if exp_mode == "lut":
        _expect(lut, "lut", torch.float16, (1, ref.LUT_SIZE), dev)
        lut_ptr = lut.data_ptr()
    cb_ptr = None
    if loader == _LOADERS["q4"]:
        _expect(codebook, "codebook", torch.float32, (16,), dev)
        cb_ptr = codebook.data_ptr()
    out = torch.empty_like(q)
    if B == 0:
        return out
    with torch.cuda.device(dev):
        err = _lib().paged_attention_launch(
            _DTYPES[q.dtype], loader, int(exp_mode == "lut"), q.data_ptr(),
            k.data_ptr(), v.data_ptr(), ks, vs, table.data_ptr(),
            lengths.data_ptr(), lut_ptr, cb_ptr, out.data_ptr(), B, Hkv, G,
            D, bs, W, Hs, Ds, gr, gc, int(window), 1.0 / math.sqrt(D),
            float(softcap), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed with CUDA "
                           f"error {err}")
    return out


def paged_attention(q, k_pool, v_pool, table, lengths, lut=None, *,
                    window: int = 0, softcap: float = 0.0,
                    exp_mode: str = "exact"):
    """K1: q (B, Hkv, G, D); fp pools (n_blocks, bs, Hkv, D) of q's dtype;
    table (B, W) int32 (padding = scratch block 0); lengths (B,) int32
    including the current token; ``lut`` the (1, 32768) fp16 exp table
    under ``exp_mode='lut'``.  Returns (B, Hkv, G, D) in q.dtype."""
    _check_mode(exp_mode, lut)
    if q.device.type == "cpu":
        return _plain(q, k_pool, v_pool, table, lengths, lut, window,
                      softcap, exp_mode)
    if isinstance(k_pool, dict):
        raise ValueError("paged_attention takes fp pools; quantized pools "
                         "go to quant_paged_attention")
    out = _launch(q, k_pool, v_pool, table, lengths, lut, None,
                  window=window, softcap=softcap, exp_mode=exp_mode)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def quant_paged_attention(q, k_pool, v_pool, table, lengths, lut=None,
                          codebook=None, *, window: int = 0,
                          softcap: float = 0.0, exp_mode: str = "exact"):
    """K2: as :func:`paged_attention` over tile-quantized pools —
    {"codes", "scales"} dicts with codes (n_blocks, bs, Hkv, Dc) int8 (q8)
    or packed uint8 (q4) and f16 scales (n_blocks, bs, Hkv//gr, D//gc).
    ``codebook`` is the (16,) f32 q4_0 table (q4 pools)."""
    _check_mode(exp_mode, lut)
    if q.device.type == "cpu":
        return _plain(q, k_pool, v_pool, table, lengths, lut, window,
                      softcap, exp_mode)
    if not isinstance(k_pool, dict):
        raise ValueError("quant_paged_attention takes quantized pools")
    out = _launch(q, k_pool, v_pool, table, lengths, lut, codebook,
                  window=window, softcap=softcap, exp_mode=exp_mode)
    quant_paged_attention.launches += 1
    return out


quant_paged_attention.launches = 0
