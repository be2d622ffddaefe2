"""olmoe-1b-7b [moe]: 16L d=2048 16H (kv=16) expert d_ff=1024 vocab=50304 —
64 experts, top-8. [arXiv:2409.02060; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="transformer",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=0, vocab_size=50304,
    moe=MoEConfig(n_experts=64, top_k=8, expert_d_ff=1024),
)

SMOKE = ModelConfig(
    name="olmoe-1b-7b-smoke", family="transformer",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=0, vocab_size=512,
    moe=MoEConfig(n_experts=8, top_k=2, expert_d_ff=64),
    dtype="float32",
)
