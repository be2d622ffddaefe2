"""Random f32 weights from ``--seed``, made on the device.

The tree is the JAX package's layout, which its checkpoints fix: layer
leaves stacked on a leading (L, ...) axis, linear weights (in, out).
One draw per stacked leaf, in a fixed order, from one generator on the
device, so the same seed gives the same weights and the reference can
make them again after the window.  ``split_layers`` hands the port its
per-layer list of views of the same storage.
"""
from __future__ import annotations

import math

import torch


def make(model: dict, seed: int, device) -> dict:
    """The f32 tree of a configuration file's ``model`` section: dense
    weights N(0, 1 / fan_in), biases N(0, 0.1^2), norm scales
    1 + N(0, 0.1^2), the tied embedding N(0, 0.02^2)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    L, d = model["n_layers"], model["d_model"]
    hq, hkv, hd, f = (model["n_heads"], model["n_kv_heads"],
                      model["head_dim"], model["d_ff"])

    def normal(shape, scale, shift=0.0):
        t = torch.randn(shape, generator=gen, device=device)
        return t.mul_(scale).add_(shift) if shift else t.mul_(scale)

    def dense(i, o, bias):
        p = {"w": normal((L, i, o), 1.0 / math.sqrt(i))}
        if bias:
            p["b"] = normal((L, o), 0.1)
        return p

    bias = bool(model.get("qkv_bias", False))
    layers = {
        "attn_norm": {"scale": normal((L, d), 0.1, 1.0)},
        "attn": {"wq": dense(d, hq * hd, bias), "wk": dense(d, hkv * hd, bias),
                 "wv": dense(d, hkv * hd, bias),
                 "wo": dense(hq * hd, d, False)},
        "ffn_norm": {"scale": normal((L, d), 0.1, 1.0)},
        "ffn": {"gate": dense(d, f, False), "up": dense(d, f, False),
                "down": dense(f, d, False)},
    }
    tree = {"embedding": {"table": normal((model["vocab_size"], d), 0.02)},
            "layers": layers,
            "final_norm": {"scale": normal((d,), 0.1, 1.0)}}
    if not model.get("tie_embeddings", True):
        tree["lm_head"] = {"table": normal((model["vocab_size"], d), 0.02)}
    return tree


def split_layers(tree: dict) -> dict:
    """The port's layout: ``layers`` as a list of per-layer dicts (views
    of the stacked leaves)."""

    def take(node, i):
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        return node[i]

    stacked = tree["layers"]
    first = stacked
    while isinstance(first, dict):
        first = next(iter(first.values()))
    out = dict(tree)
    out["layers"] = [take(stacked, i) for i in range(first.shape[0])]
    return out
