"""Dispatch layer between the model and the kernels.

The wrappers in ``paged_attention`` and ``lut_dequant_gemm`` launch the
CUDA kernels for CUDA tensors and run their plain versions for CPU
tensors; this module adapts the model's layouts to them, holds the
per-device constant tables (the exp LUT, the q4 codebook) and reads or
resets the wrappers' launch counters.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import lut_dequant_gemm as _gemm
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import ref
from repro_torch.quant import tile_quant as TQ

# wrapper name -> wrapper, for the launch counters
KERNELS = {
    "paged_attention": _paged.paged_attention,
    "quant_paged_attention": _paged.quant_paged_attention,
    "lut_dequant_gemm": _gemm.lut_dequant_gemm,
}

_TABLES: dict = {}


def _table(name: str, device: torch.device, build):
    key = (name, str(device))
    t = _TABLES.get(key)
    if t is None:
        t = _TABLES[key] = build().to(device)
    return t


def exp_lut(device="cpu") -> torch.Tensor:
    """The (1, 32768) fp16 exp table on ``device`` (built once per
    device)."""
    return _table("exp_lut", torch.device(device), ref.build_exp_lut)


def q4_codebook(device="cpu") -> torch.Tensor:
    """The (16,) f32 q4_0 codebook of the quantized KV pool on ``device``."""
    from repro_torch.quant.codebooks import get_codebook
    from repro_torch.serving.kv_quant import Q4_CODEBOOK

    return _table("q4_codebook", torch.device(device),
                  lambda: get_codebook(Q4_CODEBOOK))


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def gemm_launches_by_shape() -> dict:
    """K3 launches by (M, K, N) since the last reset."""
    return dict(_gemm.lut_dequant_gemm.shapes)


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    _gemm.lut_dequant_gemm.shapes.clear()


def lut_dequant_matmul(x: torch.Tensor, qw: dict, *,
                       group_size: int = 32) -> torch.Tensor:
    """x: (M, K) @ dequant(qw) for a Q4 leaf {"codes", "scales",
    "codebook"} -> (M, N) in x.dtype."""
    return _gemm.lut_dequant_gemm(
        x.contiguous(), qw["codes"], qw["scales"], qw["codebook"],
        scheme=TQ.infer_scheme(qw, group_size), group_size=group_size)


def paged_flash_decode(q, k_pool, v_pool, table, cache_len, *,
                       window: int = 0, softcap: float = 0.0,
                       exp_mode: str = "exact"):
    """Paged decode attention for the model's layout.

    q: (B, 1, Hq, D); pools: per-layer (n_blocks, bs, Hkv, D) tensors or
    {"codes", "scales"} dicts (which go to the quantized-pool kernel);
    table: (B, W) int32; cache_len: (B,) int32 including the current
    token.  Returns (B, 1, Hq, D) in q.dtype."""
    B, _, Hq, D = q.shape
    quantized = isinstance(k_pool, dict)
    Hkv = (k_pool["codes"] if quantized else k_pool).shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, D).contiguous()
    lut = exp_lut(q.device) if exp_mode == "lut" else None
    if quantized:
        o = _paged.quant_paged_attention(
            qg, k_pool, v_pool, table, cache_len, lut,
            q4_codebook(q.device), window=window, softcap=softcap,
            exp_mode=exp_mode)
    else:
        o = _paged.paged_attention(qg, k_pool, v_pool, table, cache_len, lut,
                                   window=window, softcap=softcap,
                                   exp_mode=exp_mode)
    return o.reshape(B, 1, Hq, D)
