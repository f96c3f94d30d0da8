"""Token embedding + tied LM head."""
from __future__ import annotations

import torch


def init_embedding(vocab: int, dim: int, *, generator, device, dtype=torch.float32):
    w = torch.randn((vocab, dim), generator=generator, device=device,
                    dtype=torch.float32) * (dim ** -0.5)
    return {"w": w.to(dtype)}


def apply_embedding(p, tokens: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    # gather, then cast the gathered rows: the same values as the
    # reference's cast-then-take without touching the whole table
    return p["w"][tokens.long()].to(compute_dtype)


def apply_lm_head(p, x: torch.Tensor) -> torch.Tensor:
    """Logits = x @ E^T (tied embeddings)."""
    return x @ p["w"].to(x.dtype).T
