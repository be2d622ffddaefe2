"""Carry a parameter tree of the JAX package over to the port.

The caller fetches the JAX tree to the host (``jax.device_get``), so it
arrives as nested dicts of numpy arrays and this module imports no JAX.
Stacked ``(L, ...)`` layer leaves under ``"layers"`` (and Whisper's
``"enc_layers"`` and ``"dec_layers"``) are split into the port's
per-layer lists (an MoE layer's ``moe/router/w`` and its
``moe/experts/{gate,up,down}`` stacks of shape (E, ...) included);
quantized leaves ({"codes", "scales"[, "codebook"]}, an expert stack's
with one codebook row per expert) are copied byte for byte, and so are
top-level leaves such as ``patch_proj`` and the zamba2 hybrid's
``shared_attn`` (one block, not stacked); ``ml_dtypes`` bfloat16 arrays
travel through a uint16 view.  The layer count is the leading dim of the
stacked leaves, so a transformer layer and a Mamba2 layer carry alike.
``params_to_jax`` goes the other way, stacking the port's lists.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as T
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


def _first_leaf(node):
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return np.asarray(node)


def _split_layers(stacked: dict, n_layers: int) -> list:
    def take(node, i):
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        return np.asarray(node)[i]

    return [take(stacked, i) for i in range(n_layers)]


def is_layer_stack(key: str) -> bool:
    """Whether a top-level key of a JAX tree holds stacked (L, ...) layer
    leaves: ``layers``, and Whisper's ``enc_layers`` / ``dec_layers``."""
    return key == "layers" or key.endswith("_layers")


def params_from_jax(tree: dict, device=None) -> dict:
    """The port's parameter tree for a host-fetched JAX tree (any family
    the port serves), on ``device`` (CUDA unless asked otherwise)."""
    dev = resolve_device(device)
    out = {}
    for key, node in tree.items():
        if is_layer_stack(key):
            layers = _split_layers(node, _first_leaf(node).shape[0])
            out[key] = [_convert(lp, dev) for lp in layers]
        else:
            out[key] = _convert(node, dev)
    return out


def params_to_jax(tree) -> dict:
    """The inverse of :func:`params_from_jax`: a tree of the port laid out
    as the JAX package's, nested dicts of host numpy arrays, each
    per-layer list stacked into (L, ...) leaves (``tree.stacked_leaves``,
    the layout the checkpoints share)."""
    out: dict = {}
    for path, parts, stacked in T.stacked_leaves(tree):
        host = [torch.as_tensor(p).detach().cpu().numpy() for p in parts]
        *keys, last = path.split("/")
        node = out
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = np.stack(host) if stacked else host[0]
    return out
