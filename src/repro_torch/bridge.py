"""Carry a parameter tree of the JAX package over to the port.

The caller fetches the JAX tree to the host (``jax.device_get``), so it
arrives as nested dicts of numpy arrays and this module imports no JAX.
Stacked ``(L, ...)`` layer leaves under ``"layers"`` are split into the
port's per-layer list; quantized leaves ({"codes", "scales"[,
"codebook"]}) are copied byte for byte; ``ml_dtypes`` bfloat16 arrays
travel through a uint16 view.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def to_tensor(a, device) -> torch.Tensor:
    """numpy array (any dtype, bfloat16 included) -> tensor on ``device``,
    bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def _convert(node, device):
    if isinstance(node, dict):
        return {k: _convert(v, device) for k, v in node.items()}
    return to_tensor(node, device)


def _split_layers(stacked: dict, n_layers: int) -> list:
    def take(node, i):
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        return np.asarray(node)[i]

    return [take(stacked, i) for i in range(n_layers)]


def params_from_jax(tree: dict, device=None) -> dict:
    """The port's parameter tree for a host-fetched JAX transformer tree,
    on ``device`` (CUDA unless asked otherwise)."""
    dev = resolve_device(device)
    out = {}
    for key, node in tree.items():
        if key == "layers":
            first = node["attn_norm"]["scale"]
            layers = _split_layers(node, np.asarray(first).shape[0])
            out[key] = [_convert(lp, dev) for lp in layers]
        else:
            out[key] = _convert(node, dev)
    return out
