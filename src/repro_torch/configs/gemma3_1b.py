"""gemma3-1b [dense]: 26L d=1152 4H (GQA kv=1) d_ff=6912 vocab=262144 —
5:1 local:global sliding-window attention, 128k ctx.
[hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="transformer",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab_size=262144,
    attn_pattern="local_global:5", window_size=512,
    rope_theta=1_000_000.0, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma3-1b-smoke", family="transformer",
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=512,
    attn_pattern="local_global:5", window_size=8,
    rope_theta=1_000_000.0, tie_embeddings=True, dtype="float32",
)
