"""On-device tile quantization of a weight to Q4_0 codes (K6).

Wrapper around the CUDA kernel in ``csrc/tile_quantize.cu``, which
replaces the JAX package's Pallas kernel ``tile_quantize``: a (K, N)
f32, fp16 or bf16 weight becomes packed 4-bit codes (K, N / 2) uint8 and
fp16 scales (K / 2, N / 16), one scale per (2, 16) group, scale =
absmax / 8.  This is the kernel's arithmetic (round half to even of the
weight over its f32 scale), not the offline quantizer's nearest-code
search in ``quant/tile_quant``; the two agree on all but a few codes.
For CPU tensors the wrapper runs the plain version
(:func:`plain_tile_quantize`); for CUDA tensors it launches the kernel or
raises; for ``meta`` tensors (the dry-run) it checks the operand as for
CUDA and returns empty codes and scales of the kernel's shapes.  ``tile_quantize.launches`` counts kernel launches, and
``tile_quantize.shapes`` counts them by (K, N).  :func:`empty_launch`
launches an empty kernel on the grid the kernel takes: the launch floor
its time is read against.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import build, ref

plain_tile_quantize = ref.tile_quantize_ref

_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# weights of at least this many bytes load through 256-byte L2 fetches.
# scripts/sweep_quantize.py times both loads in turns at qwen2.5-1.5b's
# quantized shapes (K 1536; N 256, 1536, 8960): the wide ones are faster
# at N 8960 (55 MB f32, 28 MB fp16 or bf16) and slower at N 1536 (9.4 MB
# f32 and below), and this threshold picks the faster load at each
WIDE_BYTES = 16 << 20


def _lib() -> ctypes.CDLL:
    lib = build.load("tile_quantize")
    fn = lib.tile_quantize_launch
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [I, P, P, P, I, I, I, P]
        fn.restype = ctypes.c_int
        lib.tile_quantize_empty_launch.argtypes = [I, I, I, P]
        lib.tile_quantize_empty_launch.restype = ctypes.c_int
    return lib


def tile_quantize(w: torch.Tensor, *, group_size: int = 32):
    """w: (K, N) f32, fp16 or bf16 -> (codes (K, N // 2) uint8, scales
    (K // 2, N // (group_size // 2)) fp16).  K must be even and N a
    multiple of ``group_size``; the CUDA kernel takes group_size 32."""
    if w.dim() != 2:
        raise ValueError(f"w must be (K, N), got {tuple(w.shape)}")
    K, N = w.shape
    if group_size < 2 or group_size % 2 or K % 2 or N % group_size:
        raise ValueError(f"tile_quantize: (2, {group_size // 2}) groups "
                         f"need K % 2 == 0 and N % {group_size} == 0, got "
                         f"(K, N) = {(K, N)}")
    if w.device.type == "cpu":
        return plain_tile_quantize(w, group_size=group_size)
    if group_size != 32:
        raise ValueError(f"the CUDA kernel takes group_size 32, got "
                         f"{group_size}")
    return _launch(w, wide_loads(w))


def wide_loads(w: torch.Tensor) -> bool:
    """Whether the kernel loads ``w`` through 256-byte L2 fetches."""
    return w.numel() * w.element_size() >= WIDE_BYTES


def _launch(w: torch.Tensor, wide: bool):
    """Launch the kernel, with 256-byte L2 fetches if ``wide``; the timing
    sweep reaches the load the wrapper does not pick through here."""
    K, N = w.shape
    if w.dtype not in _DTYPES or not w.is_contiguous() or \
            (w.device.type != "meta" and w.data_ptr() % 16):
        raise ValueError(f"w: expected a contiguous, 16-byte aligned tensor "
                         f"of {list(_DTYPES)}, got {w.dtype}")
    codes = torch.empty((K, N // 2), dtype=torch.uint8, device=w.device)
    scales = torch.empty((K // 2, N // 16), dtype=torch.float16,
                         device=w.device)
    if w.device.type == "meta":
        return codes, scales
    with torch.cuda.device(w.device):
        err = _lib().tile_quantize_launch(
            _DTYPES[w.dtype], w.data_ptr(), codes.data_ptr(),
            scales.data_ptr(), K, N, int(wide),
            torch.cuda.current_stream(w.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tile_quantize kernel launch failed with CUDA "
                           f"error {err}")
    tile_quantize.launches += 1
    tile_quantize.shapes[K, N] += 1
    return codes, scales


tile_quantize.launches = 0
tile_quantize.shapes = collections.Counter()


def empty_launch(w: torch.Tensor) -> None:
    """Launch an empty kernel on the grid :func:`tile_quantize` launches
    for ``w`` (a CUDA tensor); counted nowhere."""
    K, N = w.shape
    with torch.cuda.device(w.device):
        err = _lib().tile_quantize_empty_launch(
            _DTYPES[w.dtype], K, N,
            torch.cuda.current_stream(w.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed with CUDA error "
                           f"{err}")
