"""Rotary position embeddings (standard RoPE, half-split layout).

Every layer of a step rotates by the same positions, so the model
computes the (cos, sin) tables once per step (:func:`rope_tables`) and
hands them to each layer's :func:`apply_rope`."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (b, s) int -> (cos, sin), each (b, s, 1, head_dim/2) fp32."""
    freqs = rope_freqs(head_dim, theta, positions.device)          # (d/2,)
    angles = positions[..., None].to(torch.float32) * freqs        # (b, s, d/2)
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope(x: torch.Tensor, positions: Optional[torch.Tensor], theta: float = 10000.0,
               *, tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """x: (b, s, h, d), positions: (b, s) int (or precomputed ``tables``
    from :func:`rope_tables`). Rotation in fp32, result in x.dtype."""
    cos, sin = tables if tables is not None else rope_tables(positions, x.shape[-1], theta)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
