"""Mixture-of-Experts with capacity-bounded dispatch and SCT inside every
expert: the reference's ``src/repro/nn/moe.py`` (``init_moe``,
``_expert_matmul``, the single-device ``apply_moe``).

Tokens are scattered into an (E, C, d) buffer at positions from a cumsum
over the top-k assignments, in token-major, then-k order; a token whose
position reaches the capacity C is dropped from that expert. The experts
run as batched matmuls over the E axis (the reference's einsums, outside
any Pallas kernel), and the outputs are gathered back weighted by the
router's gates. Spectral experts are {"U": (E, d, k), "s": (E, k), "V":
(E, f, k)}; the dense (d, f) matrices never exist.

Token parity with the reference rests on three details: the router
rounds its product to the compute dtype before fp32, top-k breaks ties
toward the lower expert index as ``jax.lax.top_k`` does, and the
capacity positions follow the reference's flat order.

The reference's ``apply_moe_sharded`` (experts over a mesh) is not
ported: ``mesh=`` raises, as the serving engine does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.spectral import is_spectral
from repro_torch.nn.mlp import apply_mlp, init_mlp


def _init_expert_linear(E, m, n, rank, *, generator, device, dtype):
    """E experts' (m, n) projections: spectral (orthonormal U and V from
    one batched QR over the expert axis, the reference's geometric
    singular values) or, with rank None, dense."""
    if rank is None:
        w = torch.randn((E, m, n), generator=generator, device=device,
                        dtype=torch.float32) * m ** -0.5
        return {"w": w.to(dtype)}
    k = min(rank, m, n)
    U, _ = torch.linalg.qr(torch.randn((E, m, k), generator=generator, device=device,
                                       dtype=torch.float32))
    V, _ = torch.linalg.qr(torch.randn((E, n, k), generator=generator, device=device,
                                       dtype=torch.float32))
    decay = torch.logspace(0.0, -2.0, k, device=device, dtype=torch.float32)
    s = decay * (1.0 / math.sqrt(m) * math.sqrt(m * n) / torch.linalg.norm(decay))
    return {"U": U.to(dtype), "s": s.repeat(E, 1).to(dtype), "V": V.to(dtype)}


def init_moe(cfg, *, generator, device, dtype=torch.float32):
    """cfg needs: d_model, moe_d_ff, n_experts, n_shared_experts, mlp_rank
    (None => dense experts)."""
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    r = cfg.mlp_rank
    kw = dict(generator=generator, device=device, dtype=dtype)
    p = {
        "router": {"w": (torch.randn((d, E), generator=generator, device=device,
                                     dtype=torch.float32) * d ** -0.5).to(dtype)},
        "gate": _init_expert_linear(E, d, f, r, **kw),
        "up": _init_expert_linear(E, d, f, r, **kw),
        "down": _init_expert_linear(E, f, d, r, **kw),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(d, f * cfg.n_shared_experts, rank=r, act="swiglu", **kw)
    return p


def _expert_matmul(p, x: torch.Tensor) -> torch.Tensor:
    """x (E, C, m) through each expert's projection -> (E, C, n), in
    x.dtype (the spectral chain rounds h before the scale, as the
    reference's einsums do)."""
    if is_spectral(p):
        h = torch.bmm(x, p["U"].to(x.dtype))
        h = h * p["s"][:, None, :].to(x.dtype)
        return torch.bmm(h, p["V"].to(x.dtype).transpose(1, 2))
    return torch.bmm(x, p["w"].to(x.dtype))


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of the last axis, ties
    toward the lower index (``jax.lax.top_k``'s order; ``torch.topk``
    promises none): a stable descending sort keeps equal entries in
    index order."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(cfg, tokens: int, capacity_factor: float) -> int:
    """Slots per expert for a forward over ``tokens`` tokens (the
    reference's ``C_loc`` with one group)."""
    return max(1, int(capacity_factor * tokens * cfg.top_k / cfg.n_experts))


def apply_moe(p, x: torch.Tensor, cfg, *, capacity_factor: float = 1.25, mesh=None):
    """x: (b, s, d) -> ((b, s, d), the load-balance aux loss (fp32 0-d)).
    Capacity is sized per forward: C = max(1, int(capacity_factor * b s
    top_k / n_experts))."""
    if mesh is not None:
        raise NotImplementedError("apply_moe over a mesh (the reference's "
                                  "apply_moe_sharded) is not ported yet")
    b, s, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = b * s
    xt = x.reshape(T, d)

    logits = (xt @ p["router"]["w"].to(x.dtype)).float()               # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k(probs, K)                             # (T, K)
    if cfg.moe_norm_topk:
        gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # aux load-balance loss (Switch-style): E * sum_e f_e * P_e
    frac_tokens = F.one_hot(expert_idx, E).float().sum(dim=1).mean(dim=0)
    aux_loss = E * torch.sum(frac_tokens * probs.mean(dim=0))

    # capacity positions: the number of earlier picks of the same expert
    # in the flat (token, k) order; picks at or past C are dropped
    C = capacity(cfg, T, capacity_factor)
    flat = expert_idx.reshape(T * K)
    onehot = F.one_hot(flat, E)                                         # (TK, E)
    pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(dim=-1)
    keep = pos < C
    slot = torch.where(keep, flat * C + pos, torch.zeros_like(pos))

    # kept picks fill distinct rows; dropped ones land in a spare last row
    # (no host sync, unlike a masked scatter)
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    buf[torch.where(keep, slot, E * C)] = xt.repeat_interleave(K, dim=0)
    expert_in = buf[:E * C].view(E, C, d)

    g = _expert_matmul(p["gate"], expert_in)
    u = _expert_matmul(p["up"], expert_in)
    expert_out = _expert_matmul(p["down"], F.silu(g) * u).reshape(E * C, d)

    gathered = torch.where(keep[:, None], expert_out[slot], torch.zeros((), dtype=x.dtype,
                                                                         device=x.device))
    weighted = gathered * gate_vals.reshape(T * K, 1).to(gathered.dtype)
    out = weighted.reshape(T, K, d).sum(dim=1)
    if cfg.n_shared_experts:
        out = out + apply_mlp(p["shared"], xt, act="swiglu")
    return out.reshape(b, s, d), aux_loss
