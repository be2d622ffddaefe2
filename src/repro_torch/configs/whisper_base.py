"""whisper-base [audio]: 6L enc + 6L dec, d=512 8H d_ff=2048 vocab=51865 —
encoder-decoder; the conv audio frontend is a STUB (input_specs supplies
precomputed frame embeddings). [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    n_layers=6, n_encoder_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    head_dim=64, d_ff=2048, vocab_size=51865, qkv_bias=True,
    rope_theta=0.0, encoder_seq_len=1500, max_seq_len=33024,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="whisper-base-smoke", family="encdec",
    n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab_size=512, qkv_bias=True,
    rope_theta=0.0, encoder_seq_len=24, max_seq_len=128,
    tie_embeddings=True, dtype="float32",
)
