"""zamba2-1.2b [hybrid]: 38L d=2048 32H (kv=32) d_ff=8192 vocab=32000,
ssm_state=64 — Mamba2 backbone + one *shared* attention block applied every
6 layers. [arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000, hybrid_attn_every=6,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_width=4,
                  chunk_size=256),
)

SMOKE = ModelConfig(
    name="zamba2-1.2b-smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, hybrid_attn_every=2,
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_width=4,
                  chunk_size=8),
    dtype="float32",
)
