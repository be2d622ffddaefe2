"""Paged single-query decode attention: K1 (fp pool) and K2 (Q8/Q4 pool).

Wrappers around the CUDA kernel in ``csrc/paged_attention.cu``, which
replaces the JAX package's Pallas kernels ``paged_attention`` and
``quant_paged_attention``.  One query token per row attends against a
block pool through the row's block table, with per-row lengths, a sliding
window (<= 0 = none), tanh softcap, and an exact f32 or fp16 LUT online
softmax.  For CPU tensors the wrappers run the plain versions
(:func:`plain_paged_attention`, :func:`plain_lut_paged_attention`); for
CUDA tensors they launch the kernel or raise; for ``meta`` tensors (the
dry-run) they check the operands as for CUDA and return an empty output
of the kernel's shape and dtype.  The kernel splits each
row's blocks over :func:`splits` thread blocks (split-KV: score, attend
and fold launches; one fused launch when the table has one block).  ``launches`` on each
wrapper counts calls of the kernel.
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
# the bytes of a KV head's block row each load takes, and the most bytes
# of such a block a launch takes: kThreads x kMaxChunks (16-byte chunks)
# or kMaxChunks4 (4-byte chunks)
_MAX_BLOCK_BYTES = {16: 4 * 128 * 16, 4: 8 * 128 * 4}
# the narrowest scale group, in head dims, each chunk width takes (a chunk
# reads at most 4 scales)
_MIN_GROUP = {(16, "q8"): 4, (16, "q4"): 8, (4, "q8"): 1, (4, "q4"): 2}
_MAX_SCORES = 4 * 128            # G x bs: kMaxScores x kThreads
_MAX_SPLITS = 16
_TARGET_BLOCKS = 2 * 132         # two thread blocks per H100 SM


def splits(B: int, Hkv: int, W: int) -> int:
    """The split count of a call, from (B, Hkv, W) alone: enough splits of
    the table for ~2 thread blocks per SM and at least 2 (on the H100 the
    split launches beat the fused one-split launch also where B Hkv alone
    fills the SMs), at most one per table block."""
    want = max(2, -(-_TARGET_BLOCKS // max(1, B * Hkv)))
    return max(1, min(W, want, _MAX_SPLITS))


def _log2(n: int, what: str) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"the kernel takes power-of-two scale tiles, got "
                         f"{what} = {n}")
    return n.bit_length() - 1


def _lib() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    fn = lib.paged_attention_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([I, I, I, I] + [P] * 11 + [I] * 12
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


def chunk_bytes(row: int, mode: str = "fp", gc: int = 1) -> int:
    """The bytes of a K/V row each load of the kernel takes: 16 where
    the row is a multiple of 16 bytes and a 16-byte chunk spans at most 4
    scale groups, else 4 (quantized rows that are a multiple of 4 bytes,
    e.g. head_dim 80 at Q4: 40 bytes).  0: no chunk width takes the row."""
    for cb in (16, 4):
        if row % cb or (cb == 4 and mode == "fp"):
            continue
        if mode == "fp" or gc >= _MIN_GROUP[cb, mode]:
            return cb
    return 0


def _check(q, k_pool, v_pool, table, lengths, lut, codebook, exp_mode):
    """Check the operands as the kernel takes them (shapes, dtypes,
    devices, contiguity and the kernel's limits; not the pointers'
    alignment).  Returns the launch's geometry."""
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
        ks, vs = k_pool["scales"], v_pool["scales"]
        loader = _LOADERS[mode]
    else:
        nb, bs = k_pool.shape[:2]
        for name, pool in (("k_pool", k_pool), ("v_pool", v_pool)):
            _expect(pool, name, q.dtype, (nb, bs, Hkv, D), dev)
        k, v, ks, vs = k_pool, v_pool, None, None
        mode, gr, gc, Hs, Ds = "fp", 1, 1, 1, 1
        loader = _LOADERS["fp"]
    if D % 8 or D > 256 or G * bs > _MAX_SCORES:
        raise ValueError(f"the kernel takes head_dim a multiple of 8 up to "
                         f"256 and G x block_size <= {_MAX_SCORES}, got "
                         f"head_dim {D}, G {G}, block_size {bs}")
    row = k.shape[-1] * k.element_size()
    cb = chunk_bytes(row, mode, gc)
    if not cb:
        raise ValueError(
            f"the kernel loads K/V rows in 16-byte chunks (rows a multiple "
            f"of 16 bytes; q8 scale groups >= 4 head dims, q4 >= 8) or, "
            f"for q8/q4 codes, in 4-byte chunks (rows a multiple of 4 "
            f"bytes; q8 groups >= 1, q4 >= 2): rows of {row} bytes "
            f"(head_dim {D}, {k.dtype}) with scale groups of {gc} head dims "
            f"are not taken")
    if bs * row > _MAX_BLOCK_BYTES[cb]:
        raise ValueError(
            f"the kernel loads a K/V block as at most "
            f"{_MAX_BLOCK_BYTES[cb]} bytes of {cb}-byte chunks: {bs} rows "
            f"of {row} bytes (head_dim {D}, {k.dtype}) are not taken")
    W = table.shape[1] if table.dim() == 2 else -1
    _expect(table, "table", torch.int32, (B, W), dev)
    _expect(lengths, "lengths", torch.int32, (B,), dev)
    if exp_mode == "lut":
        _expect(lut, "lut", torch.float16, (1, ref.LUT_SIZE), dev)
    if loader == _LOADERS["q4"]:
        _expect(codebook, "codebook", torch.float32, (16,), dev)
    _log2(gr, "gr")
    _log2(gc, "gc")
    return dict(B=B, Hkv=Hkv, G=G, D=D, bs=bs, W=W, Hs=Hs, Ds=Ds, gr=gr,
                gc=gc, k=k, v=v, ks=ks, vs=vs, loader=loader, cb=cb)


def _launch(q, k_pool, v_pool, table, lengths, lut, codebook, *, window,
            softcap, exp_mode, n_splits=None):
    """Validate the operands and launch the kernel on the current stream,
    over :func:`splits` splits unless ``n_splits`` says otherwise (the
    function is the same for every split count; tests and timing only)."""
    dev = q.device
    g = _check(q, k_pool, v_pool, table, lengths, lut, codebook, exp_mode)
    B, Hkv, G, D, bs, W = (g[n] for n in ("B", "Hkv", "G", "D", "bs", "W"))
    k, v, ks, vs, cb = g["k"], g["v"], g["ks"], g["vs"], g["cb"]
    if k.data_ptr() % cb or v.data_ptr() % cb:
        raise ValueError(f"the kernel loads {cb}-byte chunks of the pools: "
                         f"pools not {cb}-byte aligned are not taken")
    ks = None if ks is None else ks.data_ptr()
    vs = None if vs is None else vs.data_ptr()
    lut_ptr = lut.data_ptr() if exp_mode == "lut" else None
    cb_ptr = codebook.data_ptr() if g["loader"] == _LOADERS["q4"] else None
    out = torch.empty_like(q)
    if B == 0:
        return out
    S = splits(B, Hkv, W) if n_splits is None else int(n_splits)
    if not 1 <= S <= min(max(1, W), _MAX_SPLITS):
        raise ValueError(f"splits must lie in [1, min(W, {_MAX_SPLITS})], "
                         f"got {S}")
    scratch = None
    if S > 1:  # scores, block maxima, split acc, l_s, C_s
        scratch = torch.empty(B * Hkv * G * (W * bs + W + S * D + 2 * S),
                              dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().paged_attention_launch(
            _DTYPES[q.dtype], g["loader"], int(exp_mode == "lut"), cb,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ks, vs,
            table.data_ptr(), lengths.data_ptr(), lut_ptr, cb_ptr,
            out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            B, Hkv, G, D, bs, W, g["Hs"], g["Ds"], _log2(g["gr"], "gr"),
            _log2(g["gc"], "gc"), int(window), S,
            1.0 / math.sqrt(D), float(softcap),
            torch.cuda.current_stream(dev).cuda_stream)
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
    if q.device.type == "meta":
        _check(q, k_pool, v_pool, table, lengths, lut, None, exp_mode)
        return torch.empty_like(q)
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
    if q.device.type == "meta":
        _check(q, k_pool, v_pool, table, lengths, lut, codebook, exp_mode)
        return torch.empty_like(q)
    out = _launch(q, k_pool, v_pool, table, lengths, lut, codebook,
                  window=window, softcap=softcap, exp_mode=exp_mode)
    quant_paged_attention.launches += 1
    return out


quant_paged_attention.launches = 0
