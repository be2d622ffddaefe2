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


def quantize_model_params(params, *, scheme: str = "tile",
                          codebook: str = "q4_0", group_size: int = 32,
                          policy=None):
    """Quantize eligible 2-D weights in a parameter tree (nested dicts and
    per-layer lists).  Returns a new tree in which quantized leaves are
    dicts {"codes", "scales"[, "codebook"]}; each weight is quantized on
    its own device, one layer at a time."""
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
        if sch is None or node.ndim != 2:
            return node
        if sch == "q4":
            return TQ.quantize(node, scheme=scheme, codebook=codebook,
                               group_size=group_size)
        return TQ.quantize_q8(node, group_size=group_size)

    return walk(params, "")


# leaves the model casts to the compute dtype at every use (linear weights
# and biases, the embedding table); norm scales stay f32 like the math
# that reads them
_COMPUTE_LEAVES = ("w", "b", "table")


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
