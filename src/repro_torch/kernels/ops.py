"""Dispatch layer between the model and the kernels.

The wrappers in ``paged_attention``, ``lut_dequant_gemm``,
``lut_dequant_kv``, ``lut_softmax_attention`` and ``tile_quantize`` launch
the CUDA kernels for CUDA tensors and run their plain versions for CPU
tensors; this module adapts the model's layouts to them, holds the
per-device constant tables (the exp LUT, the q4 codebook), reads or
resets the wrappers' launch counters, and reports each call's analytic
cost to an installable hook (:func:`set_op_hook`).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import autotune as _autotune
from repro_torch.kernels import lut_dequant_gemm as _gemm
from repro_torch.kernels import lut_dequant_kv as _dequant_kv
from repro_torch.kernels import lut_softmax_attention as _attn
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import ref
from repro_torch.kernels import tile_quantize as _tq
from repro_torch.quant import tile_quant as TQ

# wrapper name -> wrapper, for the launch counters
KERNELS = {
    "paged_attention": _paged.paged_attention,
    "quant_paged_attention": _paged.quant_paged_attention,
    "lut_dequant_gemm": _gemm.lut_dequant_gemm,
    "lut_dequant_kv": _dequant_kv.lut_dequant_kv,
    "lut_softmax_attention": _attn.lut_softmax_attention,
    "tile_quantize": _tq.tile_quantize,
}
# wrappers that also count their launches by shape
_BY_SHAPE = (_gemm.lut_dequant_gemm, _dequant_kv.lut_dequant_kv,
             _attn.lut_softmax_attention, _tq.tile_quantize)

_TABLES: dict = {}

# Kernel-dispatch recording hook (serving/profiling.KernelProfiler).
# ``hook(name, flops, hbm_bytes)`` fires once per wrapper call with the
# analytic cost from ``kernels/autotune``, under the JAX package's op
# names.  PyTorch runs eagerly, so it fires on every dispatch (the JAX
# package's fires once per trace).  None, the default, costs one ``is not
# None`` test per call: no cost is computed and nothing is built.
_OP_HOOK = None


def set_op_hook(hook):
    """Install the dispatch-layer cost hook; returns the previous one so
    callers can restore it (``set_op_hook(None)`` disables)."""
    global _OP_HOOK
    prev, _OP_HOOK = _OP_HOOK, hook
    return prev


def op_hook():
    """The installed hook, or None: dispatch sites outside this module
    test it before computing a cost."""
    return _OP_HOOK


def record_op(name: str, flops: float, hbm_bytes: float) -> None:
    """Report one op's analytic (flops, hbm_bytes) to the installed hook.
    Public so dispatch sites outside this module (the plain paged
    attention of ``layers.paged_decode_attention``) attribute through the
    same funnel."""
    if _OP_HOOK is not None:
        _OP_HOOK(name, float(flops), float(hbm_bytes))


def pool_slab_bytes(pool_leaf) -> float:
    """Storage bytes of one token's (Hkv, D) slab in a per-layer pool leaf
    ``(n_blocks, bs, Hkv, D)``: codes + scales for quantized {"codes",
    "scales"} leaves, dtype bytes for fp tensors."""
    if isinstance(pool_leaf, dict):
        c, s = pool_leaf["codes"], pool_leaf["scales"]
        return float(c.shape[-2] * c.shape[-1] * c.element_size()
                     + s.shape[-2] * s.shape[-1] * s.element_size())
    return float(pool_leaf.shape[-2] * pool_leaf.shape[-1]
                 * pool_leaf.element_size())


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
    for fn in _BY_SHAPE:
        fn.shapes.clear()


def launch_tally() -> dict:
    """Every launch counter in one flat dict: {wrapper name: launches}
    and {(wrapper name, shape): launches}."""
    out = {name: fn.launches for name, fn in KERNELS.items()}
    for name, fn in KERNELS.items():
        if fn in _BY_SHAPE:
            out.update({(name, shape): n for shape, n in fn.shapes.items()})
    return out


def tally_delta(before: dict, after: dict) -> dict:
    """The launches counted between two :func:`launch_tally` readings."""
    delta = {k: n - before.get(k, 0) for k, n in after.items()}
    return {k: n for k, n in delta.items() if n}


def add_launches(delta: dict, times: int = 1) -> None:
    """Count ``times`` x ``delta`` more launches: a replayed CUDA graph
    runs kernels no wrapper was called for."""
    for key, n in delta.items():
        if isinstance(key, tuple):
            KERNELS[key[0]].shapes[key[1]] += n * times
        else:
            KERNELS[key].launches += n * times


def lut_dequant_matmul(x: torch.Tensor, qw: dict, *,
                       group_size: int = 32) -> torch.Tensor:
    """x: (M, K) @ dequant(qw) for a Q4 leaf {"codes", "scales",
    "codebook"} -> (M, N) in x.dtype."""
    if _OP_HOOK is not None:
        codes, scales = qw["codes"], qw["scales"]
        record_op("lut_dequant_matmul", *_autotune.gemm_cost(
            x.shape[0], codes.shape[0], codes.shape[1] * 2,
            x_bytes=x.element_size(),
            scale_bytes=scales.numel() * scales.element_size()))
    return _gemm.lut_dequant_gemm(
        x.contiguous(), qw["codes"], qw["scales"], qw["codebook"],
        scheme=TQ.infer_scheme(qw, group_size), group_size=group_size)


def lut_dequant_gather(gathered):
    """Dequantize a gathered quantized-pool view through K4 (identity on
    fp tensors).

    ``gathered``: {"codes", "scales"} with any leading dims over the
    (Hkv, D) token slab, e.g. the (L, B, P, ...) prefix view of the
    engine's partial prefill.  The leading dims are flattened to R slabs
    for one kernel call and restored on the (..., Hkv, D) f32 result,
    bit-identical to ``kv_quant.dequantize_kv``."""
    if not isinstance(gathered, dict):
        return gathered
    from repro_torch.serving.kv_quant import kv_geometry

    mode, gr, gc, d = kv_geometry(gathered)
    codes, scales = gathered["codes"], gathered["scales"]
    lead = codes.shape[:-2]
    if _OP_HOOK is not None:
        record_op("lut_dequant_kv", *_autotune.dequant_kv_cost(
            math.prod(lead), codes.shape[-2], d, mode, gr=gr, gc=gc))
    out = _dequant_kv.lut_dequant_kv(
        codes.reshape(-1, *codes.shape[-2:]),
        scales.reshape(-1, *scales.shape[-2:]), q4_codebook(codes.device),
        mode=mode, gr=gr, gc=gc)
    return out.reshape(*lead, codes.shape[-2], d)


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
    if _OP_HOOK is not None:
        leaf = k_pool["codes"] if quantized else k_pool
        record_op("paged_flash_decode", *_autotune.paged_attn_cost(
            B, Hq, table.shape[1], leaf.shape[1], D,
            slab_bytes=pool_slab_bytes(k_pool), q_bytes=q.element_size()))
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


def flash_attention(q, k, v, *, causal: bool = True, exp_mode: str = "lut",
                    bq: int = 128, bkv: int = 128):
    """LUT-softmax FlashAttention (Alg. 1) with GQA.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D), any fp dtype, computed in
    fp16.  Blocks are ``autotune.attn_blocks`` at targets ``bq`` and
    ``bkv``: a measured entry of this card, else ``pick_block(Sq, bq)``
    and ``pick_block(Skv, bkv)``; query head h reads KV head
    h // (Hq // Hkv).  Returns (B, Sq, Hq, D)
    in q.dtype."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = k.shape
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if _OP_HOOK is not None:
        record_op("flash_attention",
                  *_autotune.attn_cost(B * Hq, Sq, Skv, D))

    def heads_first(x, S, H):
        return x.transpose(1, 2).reshape(B * H, S, D).to(
            torch.float16).contiguous()

    bq, bkv = _autotune.attn_blocks(B * Hq, Sq, Skv, D, bq_target=bq,
                                    bkv_target=bkv)
    o = _attn.lut_softmax_attention(
        heads_first(q, Sq, Hq), heads_first(k, Skv, Hkv),
        heads_first(v, Skv, Hkv), exp_lut(q.device), causal=causal,
        bq=bq, bkv=bkv, exp_mode=exp_mode, kv_group=Hq // Hkv)
    return o.reshape(B, Hq, Sq, D).transpose(1, 2).to(q.dtype)


def tile_quantize_op(w: torch.Tensor, *, group_size: int = 32) -> dict:
    """Quantize a (K, N) weight on its device through K6 -> the Q4 leaf
    {"codes", "scales", "codebook": q4_0} that ``lut_dequant_matmul``
    takes."""
    from repro_torch.quant.codebooks import get_codebook

    if _OP_HOOK is not None:
        K, N = w.shape
        record_op("tile_quantize", *_autotune.quantize_cost(
            K, N, scale_bytes=K * N // (group_size // 2)))
    codes, scales = _tq.tile_quantize(w, group_size=group_size)
    return {"codes": codes, "scales": scales,
            "codebook": get_codebook("q4_0", device=w.device)}
