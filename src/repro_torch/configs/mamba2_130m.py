"""mamba2-130m [ssm]: 24L d=768 (attention-free) vocab=50280, ssm_state=128 —
SSD (state-space duality). [arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="mamba2",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=50280, tie_embeddings=True,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4,
                  chunk_size=128),
)

SMOKE = ModelConfig(
    name="mamba2-130m-smoke", family="mamba2",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=512,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_width=4,
                  chunk_size=8),
    dtype="float32",
)
