"""Model API.  Every family module exposes ``init_params(cfg, seed=,
device=)``, ``forward``, ``prefill(cache=)`` over dense rows from
``init_cache``, and ``decode_step`` over them.

* ``transformer`` (dense, GQA, QKV bias, sliding window, local:global,
  MoE, the ``patch_stub`` frontend): also the paged layout,
  ``prefill(paged=)`` (with a cached ``prefix=`` for partial prefill,
  ``embeddings=`` for a modality stub) and ``decode_step`` through a
  block table, over ``init_paged_cache``;
* ``mamba2`` (the ``mamba2`` and ``hybrid`` families: Mamba2 and the
  zamba2 shared-attention hybrid): dense rows only, conv/ssm states per
  row, and ``decode_step(keep=)`` to leave done rows' states unchanged;
* ``whisper`` (the ``encdec`` family): dense rows only, the encoder's
  frames passed as ``embeddings=`` to ``forward`` / ``prefill``, and
  ``init_cache(t_enc=)`` sizing the cross K/V rows.

``forward(..., return_aux=True)`` appends the auxiliary loss (an MoE
transformer's load-balancing term, zero elsewhere), which training adds.
``abstract_params`` and ``abstract_cache`` are the trees on the ``meta``
device (the JAX models' ``abstract_params`` / ``abstract_cache``).
"""
from __future__ import annotations

from types import ModuleType

from repro_torch.configs.base import ModelConfig
from repro_torch.models import mamba2, transformer, whisper


def get_model(cfg: ModelConfig) -> ModuleType:
    if cfg.family == "transformer":
        return transformer
    if cfg.family in mamba2.FAMILIES:
        return mamba2
    if cfg.family == "encdec":
        return whisper
    raise ValueError(f"unknown model family: {cfg.family}")


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree of ``cfg`` on the ``meta`` device: shapes and
    dtypes only, no storage (a checkpoint's restore template)."""
    return get_model(cfg).init_params(cfg, device="meta")


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                   *, t_enc: int = 0) -> dict:
    """The dense decode cache of ``cfg`` (``init_cache``) on the ``meta``
    device; ``t_enc`` sizes a Whisper cache's cross K/V rows."""
    kw = {"t_enc": t_enc} if cfg.family == "encdec" else {}
    return get_model(cfg).init_cache(cfg, batch, max_len, dtype,
                                     device="meta", **kw)
