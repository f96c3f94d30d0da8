"""Device resolution for the port's entry points.

The port's hot path is the CUDA kernels, so an entry point that is not
told otherwise runs on the card. A CPU run is something the caller asks
for (``device="cpu"``, as the tests do); it is never a silent fallback.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA device, or raise when there is none.
    An explicit device is returned as a ``torch.device`` unchanged."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def compute_dtype(cfg) -> torch.dtype:
    """The model's activation dtype (``ModelConfig.dtype``)."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def generator_for(device: torch.device, seed: int,
                  generator: Optional[torch.Generator] = None) -> torch.Generator:
    """An explicit, seeded generator on ``device`` (``generator`` wins)."""
    if generator is not None:
        return generator
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g
