"""qwen2.5-14b [dense]: 48L d=5120 40H (GQA kv=8) d_ff=13824 vocab=152064 —
GQA with QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="transformer",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=13824, vocab_size=152064, qkv_bias=True,
)

SMOKE = ModelConfig(
    name="qwen2.5-14b-smoke", family="transformer",
    n_layers=2, d_model=80, n_heads=5, n_kv_heads=1, head_dim=16,
    d_ff=192, vocab_size=512, qkv_bias=True, dtype="float32",
)
