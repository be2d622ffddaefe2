"""Model / run configuration system.

Every architecture in the assigned pool is expressed as a ``ModelConfig``.
A config is a frozen dataclass so it can be hashed into jit static args and
serialized into checkpoints / launch manifests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Input shapes assigned to the LM family (see system brief):  every arch is
# exercised against all four shapes (long_500k only for sub-quadratic archs).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", 4096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32768, 128, "decode")
LONG_500K = InputShape("long_500k", 524288, 1, "decode")

ALL_SHAPES: Tuple[InputShape, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 256
    ngroups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    """Unified configuration covering the full architecture pool."""

    name: str = "model"
    family: str = "transformer"  # transformer | mamba2 | hybrid | encdec
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 512
    head_dim: int = 0  # 0 => d_model // n_heads

    # Attention variants -----------------------------------------------------
    attn_pattern: str = "global"  # "global" | "local_global:5" | "window"
    window_size: int = 0          # sliding window (0 = unbounded)
    qkv_bias: bool = False
    logit_softcap: float = 0.0
    rope_theta: float = 10000.0

    # MoE ---------------------------------------------------------------------
    moe: Optional[MoEConfig] = None

    # SSM / hybrid -------------------------------------------------------------
    ssm: Optional[SSMConfig] = None
    hybrid_attn_every: int = 0  # zamba2-style shared attention block cadence

    # Encoder-decoder ------------------------------------------------------------
    n_encoder_layers: int = 0
    encoder_seq_len: int = 1500  # whisper audio frames after conv frontend

    # Modality frontend: "none" | "patch_stub" | "audio_stub"
    frontend: str = "none"

    # Numerics -------------------------------------------------------------------
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"       # activation/compute dtype
    param_dtype: str = "float32"  # master param dtype
    tie_embeddings: bool = False
    max_seq_len: int = 524288

    # Paper technique knobs --------------------------------------------------------
    quantization: Optional[str] = None  # None | "q4_tile" | "q4_common" | "q8_tile"
    quant_group_size: int = 32
    lut_attention: bool = False  # use the LUT-softmax Pallas path on TPU

    # Distribution ------------------------------------------------------------------
    remat: str = "full"  # "none" | "full" | "dots"
    kv_partition: str = "batch"  # "batch" | "sequence" (sequence-parallel decode)
    # Ring (circular) KV cache for uniformly-windowed attention (mixtral
    # SWA): cache holds only `window_size` slots, slot = pos % window.
    ring_cache: bool = False

    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch can run long_500k (bounded or linear state)."""
        if self.family in ("mamba2", "hybrid"):
            return True
        if self.window_size > 0:
            return True
        if self.attn_pattern.startswith("local_global"):
            return True
        return False

    @property
    def has_decode(self) -> bool:
        return True  # every assigned arch (incl. enc-dec) has a decode step

    def supports_shape(self, shape: InputShape) -> bool:
        if shape.name == "long_500k":
            return self.sub_quadratic
        return True

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- Parameter count (for roofline MODEL_FLOPS = 6*N*D) --------------------
    def param_count(self, active_only: bool = False) -> int:
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        hd = self.resolved_head_dim()
        nq, nkv = self.n_heads, self.n_kv_heads
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = emb

        def attn_params() -> int:
            return d * hd * nq + 2 * d * hd * nkv + hd * nq * d

        def dense_ffn() -> int:
            return 3 * d * f  # gate/up/down (SwiGLU)

        def moe_ffn(active: bool) -> int:
            m = self.moe
            n_e = m.top_k if active else m.n_experts
            return 3 * d * m.expert_d_ff * n_e + d * m.n_experts  # + router

        def mamba_params() -> int:
            s = self.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            conv_dim = di + 2 * s.ngroups * s.d_state
            return (
                d * (2 * di + 2 * s.ngroups * s.d_state + nh)  # in_proj
                + conv_dim * s.conv_width
                + 2 * nh  # A_log, dt_bias
                + nh      # D
                + di * d  # out_proj
            )

        if self.family == "transformer":
            if self.moe:
                total += L * (attn_params() + moe_ffn(active_only) + 2 * d)
            else:
                total += L * (attn_params() + dense_ffn() + 2 * d)
        elif self.family == "mamba2":
            total += L * (mamba_params() + d)
        elif self.family == "hybrid":
            total += L * (mamba_params() + d)
            if self.hybrid_attn_every:
                total += attn_params() + dense_ffn() + 2 * d  # one shared block
        elif self.family == "encdec":
            enc = self.n_encoder_layers * (attn_params() + 2 * d * f + 2 * d)
            dec = L * (2 * attn_params() + 2 * d * f + 3 * d)
            total += enc + dec
        return total
