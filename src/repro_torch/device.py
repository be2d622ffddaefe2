"""Device selection shared by the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    something else.  Raises when CUDA is wanted but absent, so nothing ever
    falls back to the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (or --device cpu) to "
            "run on the CPU")
    return dev


def param_generator(device: torch.device, seed: int) -> torch.Generator:
    """A seeded generator for a model's random init on ``device``.  On the
    ``meta`` device (shapes and dtypes only: a checkpoint's restore
    template) the generator is the CPU's, which ``meta`` draws accept."""
    gen = torch.Generator(device="cpu" if device.type == "meta" else device)
    gen.manual_seed(seed)
    return gen
