"""A tiny W4A16-tileable cell for the CPU tests: the port's plain kernels
serve it, the reference judges it."""
from __future__ import annotations

import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(ROOT), str(ROOT.parent / "src")]

from benchlib import spec  # noqa: E402

CONFIG = {"name": "tiny", "num_hidden_layers": 2, "hidden_size": 64,
          "intermediate_size": 128, "num_attention_heads": 4,
          "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 512,
          "attention_bias": True, "tie_word_embeddings": True,
          "rms_norm_eps": 1e-6, "rope_theta": 10000.0,
          "torch_dtype": "float32", "reference": "transformer",
          "serving": {"kv_quant": "q8", "paged_attention": "exact"}}


# a wider one, whose logits spread as the full-size model's do
WIDE = dict(CONFIG, name="wide", hidden_size=512, intermediate_size=1024,
            num_attention_heads=8, head_dim=64, vocab_size=4096)


def port_cfg(config: dict = CONFIG):
    from repro_torch.configs.base import ModelConfig

    return ModelConfig(
        name=config["name"], family="transformer",
        n_layers=config["num_hidden_layers"], d_model=config["hidden_size"],
        n_heads=config["num_attention_heads"],
        n_kv_heads=config["num_key_value_heads"],
        head_dim=config["head_dim"], d_ff=config["intermediate_size"],
        vocab_size=config["vocab_size"], qkv_bias=True, tie_embeddings=True,
        dtype="float32")


def mix(header: int = 0, clients: int = 2, n: int = 3,
        out: int = 10) -> dict:
    return {"generator": "closed_best_of_n", "clients": clients,
            "n_samples": n,
            "prompt": {"median": 12, "sigma": 0.5, "min": 6, "max": 20},
            "output": {"median": out, "sigma": 0.5, "min": 4,
                       "max": int(1.6 * out)},
            "header_tokens": header, "temperature": 0.8,
            "prefix_cache": bool(header)}


def cell(header: int = 0, judge_tasks: int = 3, config: dict = CONFIG,
         **kw) -> spec.Cell:
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    limits = {"judge_tasks": judge_tasks, "judged_tokens_min": 10,
              "gap_max": {"limit": 1e-3}, "gap_mean": {"limit": 1e-5}}
    return spec.Cell(name="tiny", chips=1, config=dict(config),
                     traffic=mix(header, **kw), limits=limits,
                     end_to_end=bench["end_to_end"],
                     per_layer=bench["per_layer"],
                     family=spec.family_module(config["reference"]))
