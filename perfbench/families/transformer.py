"""The dense decoder family: a GQA transformer with a SwiGLU FFN in every
layer and full attention over the whole context in every layer (the
qwen2.5 cells).

A family file is found by the configuration file's ``reference`` key,
beside ``reference/<reference>.py``, and gives the harness everything
that depends on the model's kind:

- ``dims(config)``: the widths and constants the weights, the reference
  and the readers use, under the names below (``n_layers``, ``d_model``,
  ``n_heads``, ``n_kv_heads``, ``head_dim``, ``vocab_size``, ...);
- ``port_config(config)``: the port's ``ModelConfig`` the file names,
  checked against the file;
- ``make_weights(dims, seed, device)``: (top, layers), the f32 weights
  from the seed, the non-layer leaves and an iterator of the port's
  per-layer dicts, so that a tree too large for the card is never whole;
- the model's cost rules, which the per-layer readers call:
  ``token_flops``, ``head_flops``, ``attn_flops``, ``k2_keys`` and
  ``k2_launches_per_step``.
"""
from __future__ import annotations

import math
from dataclasses import replace

import torch

# configuration-file keys (the published config's names) -> dims
HF_KEYS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
           "num_attention_heads": "n_heads",
           "num_key_value_heads": "n_kv_heads", "head_dim": "head_dim",
           "intermediate_size": "d_ff", "vocab_size": "vocab_size",
           "attention_bias": "qkv_bias",
           "tie_word_embeddings": "tie_embeddings",
           "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps"}


def dims(config: dict) -> dict:
    """The widths and constants of a configuration file."""
    return {v: config[k] for k, v in HF_KEYS.items() if k in config}


def port_config(config: dict):
    """The port's ``ModelConfig`` the file names, with the file's rope
    theta (the port reads it at every call), checked number by number
    against the file: the file is the configuration as it is run."""
    from repro_torch.configs.registry import get_config

    m = dims(config)
    cfg = replace(get_config(config["port_arch"]),
                  rope_theta=m["rope_theta"])
    have = {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
            "head_dim": cfg.resolved_head_dim(), "d_ff": cfg.d_ff,
            "vocab_size": cfg.vocab_size, "qkv_bias": cfg.qkv_bias,
            "tie_embeddings": cfg.tie_embeddings,
            "rope_theta": cfg.rope_theta, "norm_eps": cfg.norm_eps}
    bad = {k: (m[k], have[k]) for k in m if m[k] != have[k]}
    if bad or cfg.moe is not None or cfg.family != "transformer":
        raise ValueError(f"{config['name']}: the port's "
                         f"{config['port_arch']} differs from the file "
                         f"(file, port): {bad}")
    if config["torch_dtype"] != cfg.dtype:
        raise ValueError(f"compute dtype {cfg.dtype} is not the file's "
                         f"{config['torch_dtype']}")
    return cfg


def make_weights(m: dict, seed: int, device):
    """(top, layers): dense weights N(0, 1 / fan_in), biases N(0, 0.1^2),
    norm scales 1 + N(0, 0.1^2), the embedding N(0, 0.02^2), from one
    generator on the device.  One draw per leaf stacked on a leading
    (L, ...) axis (the JAX package's layout, which its checkpoints fix),
    in a fixed order, so the same seed gives the same weights; ``layers``
    yields each layer's dict of views of the stacked leaves, linear
    weights (in, out)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    L, d = m["n_layers"], m["d_model"]
    hq, hkv, hd, f = m["n_heads"], m["n_kv_heads"], m["head_dim"], m["d_ff"]

    def normal(shape, scale, shift=0.0):
        t = torch.randn(shape, generator=gen, device=device)
        return t.mul_(scale).add_(shift) if shift else t.mul_(scale)

    def dense(i, o, bias):
        p = {"w": normal((L, i, o), 1.0 / math.sqrt(i))}
        if bias:
            p["b"] = normal((L, o), 0.1)
        return p

    bias = bool(m.get("qkv_bias", False))
    stacked = {
        "attn_norm": {"scale": normal((L, d), 0.1, 1.0)},
        "attn": {"wq": dense(d, hq * hd, bias), "wk": dense(d, hkv * hd, bias),
                 "wv": dense(d, hkv * hd, bias),
                 "wo": dense(hq * hd, d, False)},
        "ffn_norm": {"scale": normal((L, d), 0.1, 1.0)},
        "ffn": {"gate": dense(d, f, False), "up": dense(d, f, False),
                "down": dense(f, d, False)},
    }
    top = {"embedding": {"table": normal((m["vocab_size"], d), 0.02)},
           "final_norm": {"scale": normal((d,), 0.1, 1.0)}}
    if not m.get("tie_embeddings", True):
        top["lm_head"] = {"table": normal((m["vocab_size"], d), 0.02)}

    def take(node, i):
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        return node[i]

    return top, (take(stacked, i) for i in range(L))


def token_flops(m: dict) -> float:
    """FLOPs of one token through the projections of every layer (2 per
    multiply-add), without attention over the context and without the
    LM head."""
    d, hd = m["d_model"], m["head_dim"]
    attn = d * hd * (2 * m["n_heads"] + 2 * m["n_kv_heads"])
    ffn = 3 * d * m["d_ff"]
    return 2.0 * m["n_layers"] * (attn + ffn)


def attn_flops(m: dict, context: int) -> float:
    """QK and PV of one query over its ``context`` keys, every layer."""
    return 4.0 * m["n_layers"] * m["n_heads"] * m["head_dim"] * context


def head_flops(m: dict) -> float:
    """One row of logits."""
    return 2.0 * m["d_model"] * m["vocab_size"]


def k2_keys(m: dict, context: int) -> int:
    """The keys K2 reads for one decode row at ``context``, summed over
    the layers that launch it: every layer attends the whole context."""
    return m["n_layers"] * context


def k2_launches_per_step(m: dict) -> int:
    """K2's launches in one decode step: one per layer."""
    return m["n_layers"]
