"""AdamW with per-component learning rates (the reference's
``optim/adamw.py``): spectral U/V factors, singular values s and dense
leaves can each scale the learning rate, and spectral leaves skip weight
decay unless ``decay_spectral``. Moment math is fp32; ``moment_dtype``
is the storage dtype of mu/nu.

Trees are nested dicts of tensors in the reference's layout; the state
is ``{"mu": tree, "nu": tree, "count": int32 0-d}``, the reference's
checkpoint layout.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.spectral import is_spectral
from repro_torch.core.tree import tree_leaves


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 5e-4                  # paper's SCT learning rate
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    spectral_lr_scale: float = 1.0    # U, V factors
    sv_lr_scale: float = 1.0          # singular values s
    dense_lr_scale: float = 1.0       # everything else
    decay_spectral: bool = False      # weight decay fights orthonormality
    moment_dtype: str = "float32"


def _map(fn, *trees):
    """Apply ``fn`` leaf-wise over trees of the same layout."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def adamw_init(params: Any, moment_dtype: str = "float32") -> dict:
    md = getattr(torch, moment_dtype)
    device = tree_leaves(params)[0].device
    return {"mu": _map(lambda p: torch.zeros_like(p, dtype=md), params),
            "nu": _map(lambda p: torch.zeros_like(p, dtype=md), params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def _leaf_kind_tree(params: Any):
    """0 = dense, 1 = spectral U/V, 2 = spectral s. Mirrors params."""
    if is_spectral(params):
        return {k: (1 if k in ("U", "V") else 2 if k == "s" else 0) for k in params}
    if isinstance(params, dict):
        return {k: _leaf_kind_tree(v) for k, v in params.items()}
    return 0


def adamw_update(params: Any, grads: Any, state: dict, cfg: AdamWConfig,
                 lr_t: Optional[float] = None):
    """One AdamW step; ``lr_t`` overrides ``cfg.lr`` (the schedule's
    value). Returns (new_params, new_state): the given params, mu and nu,
    updated in place (the reference's jit donates them). Each leaf's
    arithmetic runs in fp32 on ``t.to(torch.float32)``, which is the leaf
    itself for fp32 leaves, and is stored back with ``copy_``, which
    returns at once when the source is the destination: an fp32 leaf is
    updated where it lies, with the functional form's bits (a bf16 leaf is
    updated in fp32 and rounded once, as the reference's ``astype``), and a
    functional update would hold old and new params, mu and nu of the
    whole tree at once, which a full-width deepseek step cannot spare."""
    count = state["count"] + 1
    cf = count.to(torch.float32)
    b1c = 1.0 - torch.tensor(cfg.b1, dtype=torch.float32, device=cf.device) ** cf
    b2c = 1.0 - torch.tensor(cfg.b2, dtype=torch.float32, device=cf.device) ** cf
    base_lr = cfg.lr if lr_t is None else lr_t
    scales = {0: cfg.dense_lr_scale, 1: cfg.spectral_lr_scale, 2: cfg.sv_lr_scale}

    def upd(p, g, mu, nu, kind):
        g = g.to(torch.float32)
        wd = 0.0 if kind in (1, 2) and not cfg.decay_spectral else cfg.weight_decay
        mu32, nu32, pf = (t.to(torch.float32) for t in (mu, nu, p))
        mu32.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu32.mul_(cfg.b2).add_((1 - cfg.b2) * (g * g))
        step = (mu32 / b1c).div_((nu32 / b2c).sqrt_().add_(cfg.eps))
        pf.sub_(base_lr * scales[kind] * step.add_(wd * pf))
        return p.copy_(pf), mu.copy_(mu32), nu.copy_(nu32)

    out = _map(upd, params, grads, state["mu"], state["nu"], _leaf_kind_tree(params))
    new_params, mu, nu = (_map(lambda o, i=i: o[i], out) for i in range(3))
    return new_params, {"mu": mu, "nu": nu, "count": count}
