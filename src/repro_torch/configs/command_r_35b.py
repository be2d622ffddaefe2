"""command-r-35b [dense]: 40L d=8192 64H (GQA kv=8) d_ff=22528 vocab=256000 —
GQA, no bias. [hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="transformer",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22528, vocab_size=256000,
)

SMOKE = ModelConfig(
    name="command-r-35b-smoke", family="transformer",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=1, head_dim=16,
    d_ff=256, vocab_size=512, dtype="float32",
)
