"""Model API.  The port covers the transformer family only:
``init_params(cfg, seed=, device=)``, ``forward``, ``prefill(paged=)``,
``decode_step`` over a paged cache, ``init_paged_cache`` (see
``repro_torch.models.transformer``)."""
from __future__ import annotations

from types import ModuleType

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def get_model(cfg: ModelConfig) -> ModuleType:
    if cfg.family == "transformer" and cfg.moe is None:
        return transformer
    raise ValueError(f"the port supports the dense transformer family only, "
                     f"got {cfg.family!r}")
