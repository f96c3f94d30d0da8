"""Rotary position embeddings (half-split layout): standard RoPE and
Qwen2-VL's M-RoPE.

Every layer of a step rotates by the same positions, so the model
computes the (cos, sin) tables once per step (:func:`rope_tables`,
:func:`mrope_tables`) and hands them to each layer's :func:`apply_rope`.

M-RoPE splits the rotary half-dimension into (temporal, height, width)
sections, each rotated by its own position stream. For text-only input
the three streams are equal and M-RoPE is RoPE exactly. The reference
(``src/repro/nn/rotary.py:34``) selects each slot's stream with a
one-hot product, which is exact; here an index over the stream axis
selects it, so the angles are the same bits.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

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


def mrope_tables(positions: torch.Tensor, head_dim: int, sections: Sequence[int],
                 theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (3, b, s) int (temporal, height, width ids) -> (cos, sin),
    each (b, s, 1, head_dim/2) fp32. ``sections`` are in half-dim units
    and must sum to ``head_dim // 2``: slot j of the half-dim takes the
    stream of the section it falls in."""
    half = head_dim // 2
    assert sum(sections) == half, (tuple(sections), half)
    freqs = rope_freqs(head_dim, theta, positions.device)              # (half,)
    angles = positions[..., None].to(torch.float32) * freqs            # (3, b, s, half)
    sect_id = torch.repeat_interleave(
        torch.arange(len(sections), device=positions.device),
        torch.as_tensor(list(sections), device=positions.device))      # (half,)
    sel = sect_id.view(1, 1, 1, half).expand(1, *angles.shape[1:])
    angles = torch.gather(angles, 0, sel)[0]                           # (b, s, half)
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                sections: Sequence[int] = (16, 24, 24), theta: float = 1_000_000.0,
                *, tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: x (b, s, h, d), positions (3, b, s) (or
    precomputed ``tables`` from :func:`mrope_tables`). Rotation in fp32,
    result in x.dtype."""
    if tables is None:
        tables = mrope_tables(positions, x.shape[-1], sections, theta)
    return apply_rope(x, None, tables=tables)


def apply_rope(x: torch.Tensor, positions: Optional[torch.Tensor], theta: float = 10000.0,
               *, tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """x: (b, s, h, d), positions: (b, s) int (or precomputed ``tables``
    from :func:`rope_tables`). Rotation in fp32, result in x.dtype."""
    cos, sin = tables if tables is not None else rope_tables(positions, x.shape[-1], theta)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
