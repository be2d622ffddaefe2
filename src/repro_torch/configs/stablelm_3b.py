"""stablelm-3b [dense]: 32L d=2560 32H (kv=32) d_ff=6912 vocab=50304.
[hf:stabilityai/stablelm-2-1_6b; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="transformer",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=6912, vocab_size=50304,
)

SMOKE = ModelConfig(
    name="stablelm-3b-smoke", family="transformer",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, dtype="float32",
)
