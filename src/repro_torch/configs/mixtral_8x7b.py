"""mixtral-8x7b [moe]: 32L d=4096 32H (GQA kv=8) expert d_ff=14336
vocab=32000 — 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="transformer",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=0, vocab_size=32000, window_size=4096,
    moe=MoEConfig(n_experts=8, top_k=2, expert_d_ff=14336),
)

SMOKE = ModelConfig(
    name="mixtral-8x7b-smoke", family="transformer",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=0, vocab_size=512, window_size=16,
    moe=MoEConfig(n_experts=4, top_k=2, expert_d_ff=96),
    dtype="float32",
)
