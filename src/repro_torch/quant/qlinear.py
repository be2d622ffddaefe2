"""Quantized linear application + whole-model quantization policy.

``quantized_matmul`` is the integration point used by
``models.layers.linear``.  A Q4 leaf ({"codes", "scales", "codebook"})
goes through ``kernels.ops.lut_dequant_matmul``: the hand-written LUT
dequant GEMM for CUDA tensors, its plain version for CPU tensors.  A Q8
leaf ({"codes", "scales"}) is dequantized and multiplied with
``torch.matmul``, as the JAX package leaves it to XLA.

``quantize_model_params`` applies the paper's deployment policy: Q4 tile
quantization for attention and FFN projections, Q8_0 for the FFN down
projection (§7.1), embeddings / norms / small vectors left in fp.
"""
from __future__ import annotations

import re

import torch

from repro_torch.quant import tile_quant as TQ


def is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and "codes" in leaf


def quantized_matmul(x: torch.Tensor, qw: dict,
                     group_size: int = 32) -> torch.Tensor:
    """x: (..., K) @ dequant(qw) (K, N) -> (..., N) in x.dtype."""
    if "codebook" in qw:
        from repro_torch.kernels import ops

        lead = x.shape[:-1]
        y = ops.lut_dequant_matmul(x.reshape(-1, x.shape[-1]), qw,
                                   group_size=group_size)
        return y.reshape(*lead, y.shape[-1])
    w = TQ.dequantize_q8(qw, dtype=x.dtype, group_size=group_size)
    return torch.matmul(x, w)


# path regex -> scheme name ("q4" | "q8" | None). First match wins.
DEFAULT_POLICY = [
    (r".*(down|fc2)/w$", "q8"),            # FFN down: Q8_0 (paper §7.1)
    (r".*(gate|up|fc1)/w$", "q4"),
    (r".*w[qkvo]/w$", "q4"),
    (r".*in_proj/w$", "q4"),
    (r".*out_proj/w$", "q4"),
    (r".*experts/down$", "q8"),
    (r".*experts/(gate|up)$", "q4"),
    (r".*", None),                          # embeddings, norms, etc.
]


def _stacked(fn, w: torch.Tensor) -> dict:
    """``fn`` over every (K, N) matrix of a stacked (..., K, N) weight (an
    MoE layer's experts), one matrix at a time, each output leaf stacked
    back behind the same leading dims: the codebook too, once per matrix,
    (..., 16), as the JAX package's ``vmap`` broadcasts it."""
    lead = w.shape[:-2]
    parts = [fn(m) for m in w.reshape(-1, *w.shape[-2:])]
    return {k: torch.stack([p[k] for p in parts]).reshape(
        *lead, *parts[0][k].shape) for k in parts[0]}


_META_LEAVES: dict = {}


def _meta_quantized(fn, key, w: torch.Tensor) -> dict:
    """``fn``'s leaf for a ``meta`` weight (any leading dims): the
    quantizer runs once per (K, N) matrix shape and dtype, and each part
    of its result is an empty ``meta`` tensor behind ``w``'s leading
    dims, as ``_stacked`` stacks them."""
    k = key + (tuple(w.shape[-2:]), w.dtype)
    if k not in _META_LEAVES:
        _META_LEAVES[k] = {n: (tuple(t.shape), t.dtype) for n, t in
                           fn(torch.empty(w.shape[-2:], dtype=w.dtype,
                                          device="meta")).items()}
    lead = tuple(w.shape[:-2])
    return {n: torch.empty(lead + shape, dtype=dtype, device="meta")
            for n, (shape, dtype) in _META_LEAVES[k].items()}


def quantize_model_params(params, *, scheme: str = "tile",
                          codebook: str = "q4_0", group_size: int = 32,
                          policy=None):
    """Quantize eligible weights in a parameter tree (nested dicts and
    per-layer lists).  Returns a new tree in which quantized leaves are
    dicts {"codes", "scales"[, "codebook"]}; each weight is quantized on
    its own device, one layer at a time, and a stacked weight of rank 3
    or 4 (experts) one matrix at a time.  ``meta`` weights (shapes only:
    the dry-run) are quantized once per matrix shape."""
    policy = policy or DEFAULT_POLICY

    def decide(path: str):
        for pat, sch in policy:
            if re.match(pat, path):
                return sch
        return None

    def walk(node, path: str):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else str(k))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, f"{path}/{i}") for i, v in enumerate(node)]
        sch = decide(path)
        if sch is None or node.ndim not in (2, 3, 4):
            return node
        if sch == "q4":
            fn = lambda w: TQ.quantize(w, scheme=scheme, codebook=codebook,
                                       group_size=group_size)
        else:
            fn = lambda w: TQ.quantize_q8(w, group_size=group_size)
        if node.device.type == "meta":
            return _meta_quantized(fn, (sch, scheme, codebook, group_size),
                                   node)
        return fn(node) if node.ndim == 2 else _stacked(fn, node)

    return walk(params, "")


def dequantize_leaf(leaf: dict, group_size: int = 32) -> torch.Tensor:
    """One quantized leaf (stacked or not) back to f32."""
    if "codebook" in leaf:
        return TQ.dequantize(leaf, group_size=group_size)
    return TQ.dequantize_q8(leaf, group_size=group_size)


def dequantize_model_params(params, group_size: int = 32):
    """Inverse of :func:`quantize_model_params`: every quantized leaf back
    to an f32 weight of its original shape (for accuracy baselines and
    the MoE experts, which run as dense batched products)."""
    if is_quantized(params):
        return dequantize_leaf(params, group_size)
    if isinstance(params, dict):
        return {k: dequantize_model_params(v, group_size)
                for k, v in params.items()}
    if isinstance(params, list):
        return [dequantize_model_params(v, group_size) for v in params]
    return params


# leaves the model casts to the compute dtype at every use (linear weights
# and biases, the embedding table, fp expert stacks); norm scales stay f32
# like the math that reads them
_COMPUTE_LEAVES = ("w", "b", "table", "gate", "up", "down")


def cast_params(params, dtype: torch.dtype):
    """Cast the fp weight, bias and embedding leaves to ``dtype`` (the
    compute dtype) once at load instead of at every use; the values the
    model computes with are the same.  Quantized leaves keep their stored
    types."""

    def walk(node, key=None):
        if is_quantized(node):
            return node
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node.to(dtype) if key in _COMPUTE_LEAVES else node

    return walk(params)
