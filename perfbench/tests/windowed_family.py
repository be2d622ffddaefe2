"""A second model family, as a later change would add it: a tiny
decoder whose layers attend over a sliding window three times in four,
every fourth layer over the whole context (Mellum2's pattern), with its
weights drawn a layer at a time.  The tests copy it into a perfbench
root as ``families/windowed.py``; nothing of the harness names it."""
from __future__ import annotations

import math

import torch

HF_KEYS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
           "num_attention_heads": "n_heads",
           "num_key_value_heads": "n_kv_heads", "head_dim": "head_dim",
           "intermediate_size": "d_ff", "vocab_size": "vocab_size",
           "attention_bias": "qkv_bias",
           "tie_word_embeddings": "tie_embeddings",
           "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps"}


def dims(config: dict) -> dict:
    """The file's widths, and ``windows``: each layer's window (0 for a
    full-attention layer) from ``layer_types`` and ``sliding_window``."""
    m = {v: config[k] for k, v in HF_KEYS.items() if k in config}
    m["windows"] = [config["sliding_window"] if t == "sliding_attention"
                    else 0 for t in config["layer_types"]]
    return m


def port_config(config: dict):
    """The port's ``ModelConfig`` for the file, its windows checked
    against the port's own per-layer mapping."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.transformer import layer_windows

    m = dims(config)
    cfg = ModelConfig(
        name=config["name"], family="transformer", n_layers=m["n_layers"],
        d_model=m["d_model"], n_heads=m["n_heads"],
        n_kv_heads=m["n_kv_heads"], head_dim=m["head_dim"], d_ff=m["d_ff"],
        vocab_size=m["vocab_size"], qkv_bias=m["qkv_bias"],
        tie_embeddings=m["tie_embeddings"], rope_theta=m["rope_theta"],
        norm_eps=m["norm_eps"], dtype=config["torch_dtype"],
        window_size=config["sliding_window"],
        attn_pattern=f"local_global:{m['windows'].index(0)}")
    if layer_windows(cfg) != m["windows"]:
        raise ValueError(f"the port's windows {layer_windows(cfg)} are not "
                         f"the file's {m['windows']}")
    return cfg


def make_weights(m: dict, seed: int, device):
    """(top, layers) as the dense family draws them, but one layer's
    leaves at a time: no stacked tree is ever whole."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    d, hq, hkv, hd, f = (m["d_model"], m["n_heads"], m["n_kv_heads"],
                         m["head_dim"], m["d_ff"])

    def normal(shape, scale, shift=0.0):
        t = torch.randn(shape, generator=gen, device=device)
        return t.mul_(scale).add_(shift) if shift else t.mul_(scale)

    def dense(i, o, bias):
        p = {"w": normal((i, o), 1.0 / math.sqrt(i))}
        if bias:
            p["b"] = normal((o,), 0.1)
        return p

    def layer():
        b = m["qkv_bias"]
        return {"attn_norm": {"scale": normal((d,), 0.1, 1.0)},
                "attn": {"wq": dense(d, hq * hd, b),
                         "wk": dense(d, hkv * hd, b),
                         "wv": dense(d, hkv * hd, b),
                         "wo": dense(hq * hd, d, False)},
                "ffn_norm": {"scale": normal((d,), 0.1, 1.0)},
                "ffn": {"gate": dense(d, f, False), "up": dense(d, f, False),
                        "down": dense(f, d, False)}}

    top = {"embedding": {"table": normal((m["vocab_size"], d), 0.02)},
           "final_norm": {"scale": normal((d,), 0.1, 1.0)}}
    return top, (layer() for _ in range(m["n_layers"]))


def _keys(m: dict, context: int) -> int:
    return sum(min(context, w) if w else context for w in m["windows"])


def token_flops(m: dict) -> float:
    d, hd = m["d_model"], m["head_dim"]
    attn = d * hd * (2 * m["n_heads"] + 2 * m["n_kv_heads"])
    return 2.0 * m["n_layers"] * (attn + 3 * d * m["d_ff"])


def attn_flops(m: dict, context: int) -> float:
    """QK and PV of one query: ``min(context, window)`` keys on a
    sliding layer, ``context`` on a full one."""
    return 4.0 * m["n_heads"] * m["head_dim"] * _keys(m, context)


def head_flops(m: dict) -> float:
    return 2.0 * m["d_model"] * m["vocab_size"]


def k2_keys(m: dict, context: int) -> int:
    return _keys(m, context)


def k2_launches_per_step(m: dict) -> int:
    return m["n_layers"]
