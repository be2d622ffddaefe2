"""internvl2-1b [vlm]: 24L d=896 14H (GQA kv=2) d_ff=4864 vocab=151655 —
InternViT + InternLM2/Qwen2 backbone.  The ViT frontend is a STUB:
input_specs supplies precomputed patch embeddings occupying the first
``n_patches`` positions. [arXiv:2404.16821; hf]"""
from repro_torch.configs.base import ModelConfig

N_PATCHES = 256

CONFIG = ModelConfig(
    name="internvl2-1b", family="transformer",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
    d_ff=4864, vocab_size=151655, qkv_bias=True, frontend="patch_stub",
)

SMOKE = ModelConfig(
    name="internvl2-1b-smoke", family="transformer",
    n_layers=2, d_model=56, n_heads=7, n_kv_heads=1, head_dim=8,
    d_ff=128, vocab_size=512, qkv_bias=True, frontend="patch_stub",
    dtype="float32",
)
