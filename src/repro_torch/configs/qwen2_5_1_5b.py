"""qwen2.5-1.5b — the paper's primary on-device model (§7.1)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-1.5b", family="transformer",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151936, qkv_bias=True, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen2.5-1.5b-smoke", family="transformer",
    n_layers=2, d_model=48, n_heads=6, n_kv_heads=1, head_dim=8,
    d_ff=128, vocab_size=512, qkv_bias=True, tie_embeddings=True,
    dtype="float32",
)
