"""llama3.2-1b — the paper's second model family (§7.1)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b", family="transformer",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab_size=128256, rope_theta=500000.0, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="llama3.2-1b-smoke", family="transformer",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=160, vocab_size=512, rope_theta=500000.0, tie_embeddings=True,
    dtype="float32",
)
