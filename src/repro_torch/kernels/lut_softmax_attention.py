"""LUT-softmax FlashAttention, paper Alg. 1 (K5).

Wrapper around the CUDA kernel in ``csrc/lut_softmax_attention.cu``,
which replaces the JAX package's Pallas kernel ``lut_softmax_attention``:
fp16 q (BH, Sq, D) against k, v (BH / kv_group, Skv, D), causal or not,
with the fp16 online softmax of Alg. 1 over KV blocks of ``bkv`` rows and
exp by the exp LUT (``lut``), the fp16 polynomial (``poly``) or f32 exp
(``exact``).  For CPU tensors the wrapper runs the plain version
(:func:`plain_lut_softmax_attention`); for CUDA tensors it launches the
kernel or raises; for ``meta`` tensors (the dry-run) it checks the
operands as for CUDA and returns an empty output of the kernel's shape.  ``lut_softmax_attention.launches`` counts kernel
launches, and ``lut_softmax_attention.shapes`` counts them by
(exp_mode, BH, Sq, Skv, D, kv_group, causal).
"""
from __future__ import annotations

import collections
import ctypes
import math

import torch

from repro_torch.kernels import build, ref

plain_lut_softmax_attention = ref.lut_flash_attention_ref

EXP_MODES = ref.FLASH_EXP_MODES
HEAD_DIMS = (32, 64, 128)  # the CUDA kernel's head dims
MAX_BKV = 256              # the CUDA kernel's longest KV block
ROWS_PER_BLOCK = 64        # query rows per CUDA thread block
# None: choose by grid (lut_in_shared); tests and
# scripts/compare_kernels.py set True or False to force one side
_LUT_IN_SHARED = None


def _lib() -> ctypes.CDLL:
    lib = build.load("lut_softmax_attention")
    fn = lib.lut_softmax_attention_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P] * 5 + [I] * 9 + [ctypes.c_float, P]
        fn.restype = ctypes.c_int
    return lib


def lut_in_shared(BH: int, Sq: int, device) -> bool:
    """lut mode: stage the 64 KiB exp table in shared memory once per
    thread block when the grid fits in one wave of one block per SM, where
    the table costs no occupancy; otherwise read it through the read-only
    cache (two blocks per SM)."""
    if _LUT_IN_SHARED is not None:
        return _LUT_IN_SHARED
    blocks = BH * -(-Sq // ROWS_PER_BLOCK)
    return blocks <= torch.cuda.get_device_properties(
        device).multi_processor_count


def lut_softmax_attention(q, k, v, lut, *, causal: bool = True,
                          bq: int = 128, bkv: int = 128,
                          exp_mode: str = "lut", kv_group: int = 1):
    """q: (BH, Sq, D) fp16; k, v: (BH // kv_group, Skv, D) fp16; lut: the
    (1, 32768) fp16 exp table (read in ``lut`` mode only).  Returns
    (BH, Sq, D) fp16.

    ``bq`` and ``bkv`` must divide Sq and Skv (as in the Pallas kernel);
    the result depends on ``bkv`` (the fp16 running max is rounded once
    per KV block) and not on ``bq``.  On CUDA the kernel takes head_dim
    32, 64 or 128 and ``bkv`` up to 256."""
    if exp_mode not in EXP_MODES:
        raise ValueError(f"exp_mode must be one of {EXP_MODES}, "
                         f"got {exp_mode!r}")
    BH, Sq, D = q.shape
    Skv = k.shape[1]
    bq, bkv = min(bq, Sq), min(bkv, Skv)
    if Sq % bq or Skv % bkv:
        raise ValueError(
            f"lut_softmax_attention: block sizes must divide the sequence "
            f"lengths, got Sq={Sq} with bq={bq} (Sq % bq = {Sq % bq}) and "
            f"Skv={Skv} with bkv={bkv} (Skv % bkv = {Skv % bkv})")
    if q.device.type == "cpu":
        return plain_lut_softmax_attention(q, k, v, lut, causal=causal,
                                           bkv=bkv, exp_mode=exp_mode,
                                           kv_group=kv_group)
    if kv_group < 1 or BH % kv_group:
        raise ValueError(f"kv_group={kv_group} does not divide BH={BH}")
    kv_shape = (BH // kv_group, Skv, D)
    for t, name, shape in ((q, "q", (BH, Sq, D)), (k, "k", kv_shape),
                           (v, "v", kv_shape)):
        if t.device != q.device or t.dtype != torch.float16 or \
                tuple(t.shape) != shape or not t.is_contiguous() or \
                (t.device.type != "meta" and t.data_ptr() % 16):
            raise ValueError(
                f"{name}: expected a contiguous, 16-byte aligned fp16 "
                f"{shape} tensor on {q.device}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim {HEAD_DIMS}, "
                         f"got {D}")
    if bkv > MAX_BKV:
        raise ValueError(f"the CUDA kernel takes KV blocks of at most "
                         f"{MAX_BKV} rows, got bkv={bkv}")
    if exp_mode == "lut":
        if lut is None or lut.device != q.device or \
                lut.dtype != torch.float16 or lut.numel() != ref.LUT_SIZE \
                or not lut.is_contiguous():
            raise ValueError("exp_mode='lut' needs the (1, 32768) fp16 exp "
                             "LUT on the device of q "
                             "(repro_torch.kernels.ops.exp_lut(device))")
    out = torch.empty_like(q)
    if q.device.type == "meta":
        return out
    lut_ptr = lut.data_ptr() if exp_mode == "lut" else None
    with torch.cuda.device(q.device):
        err = _lib().lut_softmax_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lut_ptr,
            out.data_ptr(), BH, Sq, Skv, D, kv_group, bkv, int(causal),
            EXP_MODES.index(exp_mode),
            int(exp_mode == "lut" and lut_in_shared(BH, Sq, q.device)),
            1.0 / math.sqrt(D),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lut_softmax_attention kernel launch failed "
                           f"with CUDA error {err}")
    lut_softmax_attention.launches += 1
    lut_softmax_attention.shapes[
        exp_mode, BH, Sq, Skv, D, kv_group, bool(causal)] += 1
    return out


lut_softmax_attention.launches = 0
lut_softmax_attention.shapes = collections.Counter()
