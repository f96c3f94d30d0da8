"""The train step builder (the reference's ``launch/steps.py``
``make_train_step``, one microbatch and no telemetry): forward and
backward through the model's loss, then the SCT optimizer's update."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.checkpoint.store import flatten, unflatten
from repro_torch.config.model_config import ModelConfig
from repro_torch.core.precision import effective_policy
from repro_torch.models.lm import require_family
from repro_torch.models.model import train_loss
from repro_torch.optim import SCTOptimizer, make_sct_optimizer


def make_train_step(cfg: ModelConfig, optimizer: Optional[SCTOptimizer] = None,
                    microbatches: int = 1, telemetry: bool = False):
    """(state, batch) -> (state, metrics). The optimizer's precision
    policy sets the forward's compute dtype (legacy: ``cfg.dtype`` over
    the fp32 masters). Metrics are 0-d tensors: ``loss``, ``ce_loss``,
    ``aux_loss``. Microbatching and rank telemetry are not ported, nor is
    training a family other than ``dense_lm`` (``models/lm.py:SUPPORT``)."""
    require_family(cfg, "train")
    if microbatches != 1:
        raise NotImplementedError("microbatched gradient accumulation is not ported")
    if telemetry:
        raise NotImplementedError("rank telemetry (rank/telemetry.py) is not ported")
    opt = optimizer or make_sct_optimizer(cfg)
    pol = effective_policy(cfg, opt.precision)
    cfg_eff = cfg.replace(dtype=pol.compute_dtype)

    def train_step(state, batch):
        leaves = {path: t.detach().requires_grad_(True)
                  for path, t in flatten(state["params"]).items()}
        with torch.enable_grad():
            loss, metrics = train_loss(unflatten(leaves), batch, cfg_eff)
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = unflatten({path: torch.zeros_like(t) if g is None else g
                           for (path, t), g in zip(leaves.items(), grads)})
        new_state = opt.apply(state, grads)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return new_state, metrics

    return train_step
