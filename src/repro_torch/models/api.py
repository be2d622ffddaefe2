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
  row, and ``decode_step(keep=)`` to leave done rows' states unchanged.
"""
from __future__ import annotations

from types import ModuleType

from repro_torch.configs.base import ModelConfig
from repro_torch.models import mamba2, transformer

# families of the JAX package the port does not serve yet, and the slice
# that ports them
_LATER = {"encdec": "Whisper (encoder-decoder)"}


def get_model(cfg: ModelConfig) -> ModuleType:
    if cfg.family == "transformer":
        return transformer
    if cfg.family in mamba2.FAMILIES:
        return mamba2
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"the port does not serve the {cfg.family!r} family yet: it "
            f"comes with the slice that ports {_LATER[cfg.family]}")
    raise ValueError(f"unknown model family: {cfg.family}")
