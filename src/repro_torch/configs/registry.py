"""Architecture registry: ``--arch <id>`` resolution for the port's
entry points.  Lists only the architectures the port serves."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    # the paper's primary on-device model
    "qwen2.5-1.5b": "qwen2_5_1_5b",
}


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str, *, smoke: bool = False) -> ModelConfig:
    mod = _module(arch)
    return mod.SMOKE if smoke else mod.CONFIG

