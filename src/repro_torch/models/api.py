"""Model API.  The port covers the transformer family (dense, GQA, QKV
bias, sliding window, local:global, MoE, the ``patch_stub`` frontend):
``init_params(cfg, seed=, device=)``, ``forward``, ``prefill(paged=)`` or
``prefill(cache=)`` (with ``embeddings=`` for a modality stub),
``decode_step`` over a paged or a dense cache, ``init_paged_cache`` and
``init_cache`` (see ``repro_torch.models.transformer``)."""
from __future__ import annotations

from types import ModuleType

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

# families of the JAX package the port does not serve yet, and the slice
# that ports them
_LATER = {"mamba2": "Mamba2 / zamba2 on the dense engine",
          "hybrid": "Mamba2 / zamba2 on the dense engine",
          "encdec": "Whisper (encoder-decoder)"}


def get_model(cfg: ModelConfig) -> ModuleType:
    if cfg.family == "transformer":
        return transformer
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"the port does not serve the {cfg.family!r} family yet: it "
            f"comes with the slice that ports {_LATER[cfg.family]}")
    raise ValueError(f"unknown model family: {cfg.family}")
