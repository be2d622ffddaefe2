"""Architecture registry: ``--arch <id>`` resolution for the port's
entry points.  Lists the JAX package's registry whole: the transformer
family (dense, GQA, QKV bias, sliding window, local:global, MoE, the
``patch_stub`` modality frontend), Mamba2 (mamba2-130m), the zamba2
hybrid (zamba2-1.2b) and the Whisper encoder-decoder (whisper-base).
``cells`` lists the dry-run's (arch x input shape) cells."""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ALL_SHAPES, ModelConfig

_ARCH_MODULES = {
    "gemma3-1b": "gemma3_1b",
    "stablelm-3b": "stablelm_3b",
    "qwen2.5-14b": "qwen2_5_14b",
    "command-r-35b": "command_r_35b",
    "internvl2-1b": "internvl2_1b",
    "mamba2-130m": "mamba2_130m",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "mixtral-8x7b": "mixtral_8x7b",
    "zamba2-1.2b": "zamba2_1_2b",
    "whisper-base": "whisper_base",
    # the paper's own models
    "qwen2.5-1.5b": "qwen2_5_1_5b",
    "llama3.2-1b": "llama3_2_1b",
}

ASSIGNED_ARCHS: List[str] = list(_ARCH_MODULES)[:10]
PAPER_ARCHS: List[str] = list(_ARCH_MODULES)[10:]


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(_ARCH_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str, *, smoke: bool = False) -> ModelConfig:
    mod = _module(arch)
    return mod.SMOKE if smoke else mod.CONFIG


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def cells(archs=None):
    """All (arch, shape) dry-run cells incl. documented skips.

    Yields (arch, shape, runnable, reason)."""
    for arch in archs or ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for shape in ALL_SHAPES:
            if cfg.supports_shape(shape):
                yield arch, shape, True, ""
            else:
                yield arch, shape, False, (
                    "pure full attention — long_500k needs sub-quadratic "
                    "attention (see DESIGN.md §Arch-applicability)")
